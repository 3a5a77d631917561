"""Export a run dir to the reference's torch on-disk layout (counterpart of
gan3d_tpu/eval/export.py:export_checkpoint).

The port's ``models/checkpoint.pt`` already holds the reference's
state_dicts (train/checkpoint.py), so the export is the layout around
them: ``out_dir/params.pkl`` (the config as an ``argparse.Namespace``)
and ``out_dir/models/checkpoint.pt`` with exactly the keys the
reference's trainer writes (trainer.py:153-163), the loss and FID
histories from the run's own checkpoint.

Optimizer states export as EMPTY torch-Adam state dicts with the
reference's param_groups (torch fills the moments on the first step), as
the JAX package documents (export.py:27-30): the port's own Adam state
(train/state.py) is not torch.optim's format, so a torch-side resume
restarts the Adam moments.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.train.checkpoint import CHECKPOINT_FILE

# state_dict entries that are buffers, not parameters: BN statistics, the
# spectral norm's vectors, StyleGAN's w_avg and 2-D noise_const
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked",
                   "_u", "_v", "w_avg", "noise_const")


def _empty_adam_state(n_params: int, lr: float) -> Dict[str, Any]:
    """A loadable torch.optim.Adam state dict with empty per-param state;
    betas as the reference's (trainer.py:77-78)."""
    return {
        "state": {},
        "param_groups": [{
            "lr": lr, "betas": (0.0, 0.9), "eps": 1e-8, "weight_decay": 0,
            "amsgrad": False, "foreach": None, "maximize": False,
            "capturable": False, "differentiable": False, "fused": None,
            "decoupled_weight_decay": False,
            "params": list(range(n_params)),
        }],
    }


def _count_torch_params(sd: Dict[str, torch.Tensor]) -> int:
    """Trainable-parameter count of a state_dict (buffers excluded)."""
    return sum(1 for k in sd if not k.endswith(BUFFER_SUFFIXES))


def export_checkpoint(run_dir: str, out_dir: str) -> str:
    """Export a run dir (the port's, or a reference one) to out_dir in the
    reference's layout; returns the checkpoint's path."""
    cfg = Config.load(run_dir)
    payload = torch.load(os.path.join(run_dir, "models", CHECKPOINT_FILE),
                         map_location="cpu", weights_only=True)
    g_sd, d_sd = payload["modelG_state_dict"], payload["modelD_state_dict"]
    os.makedirs(os.path.join(out_dir, "models"), exist_ok=True)
    with open(os.path.join(out_dir, "params.pkl"), "wb") as f:
        pickle.dump(cfg.to_namespace(), f)
    out = {
        "step": int(payload["step"]),
        "modelG_state_dict": g_sd,
        "modelD_state_dict": d_sd,
        "optimizerG_state_dict": _empty_adam_state(
            _count_torch_params(g_sd), cfg.lrG),
        "optimizerD_state_dict": _empty_adam_state(
            _count_torch_params(d_sd), cfg.lrD),
        "lossG": list(payload["lossG"]),
        "lossD": [list(x) for x in payload["lossD"]],
        "fid": list(payload["fid"]),
    }
    path = os.path.join(out_dir, "models", CHECKPOINT_FILE)
    torch.save(out, path)
    return path
