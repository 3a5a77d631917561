"""Pooled-KV voxel attention op: the plain version and the dispatcher.

The SAGAN attention (reference utils.py:34-45) computes
    beta = softmax(Q K^T);  O = beta V
with Q = [N, L, c] voxel queries and K/V = [N, M, c] max-pooled keys/values
(M = L/8). Scores are unscaled: there is no 1/sqrt(c).

- ``attention_plain``: PyTorch, chunked over queries like the JAX package's
  ``attention_chunked`` (ops/attention.py:58-76) so that the score matrix
  never exceeds [N, chunk, M] (the dense one is 512 MB per sample at the
  64^3 G placement). f32 scores, softmax and PV; differentiable to any
  order. The CPU runs it; on the card it is the kernels' yardstick only.
- ``pooled_attention``: CPU tensors go to the plain version, CUDA tensors
  to the hand-written kernels (ops/cuda_attention.py), which raise on a
  shape or dtype they do not take. Nothing falls back.
"""

from __future__ import annotations

import torch

CHUNK = 1024


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int = CHUNK) -> torch.Tensor:
    """softmax(q k^T) v in f32, over query chunks; output in q's dtype."""
    kt = k.float().transpose(1, 2)
    vf = v.float()
    outs = []
    for i in range(0, q.shape[1], chunk):
        s = torch.bmm(q[:, i:i + chunk].float(), kt)
        outs.append(torch.bmm(torch.softmax(s, dim=-1), vf))
    return torch.cat(outs, dim=1).to(q.dtype)


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """softmax(Q K^T) V over pooled keys/values. q [N,L,c], k/v [N,M,c]."""
    if q.is_cuda:
        from gan3d_tpu_torch.ops.cuda_attention import pooled_attention_cuda

        return pooled_attention_cuda(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    raise ValueError(f"pooled_attention: no implementation for device "
                     f"{q.device}")
