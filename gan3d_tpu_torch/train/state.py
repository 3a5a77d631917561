"""Adam in the JAX package's op order (gan3d_tpu/train/state.py:39-85).

torch.optim.Adam orders its arithmetic differently, so the port keeps a
small hand-written step. With b1 == 0 (the reference's betas (0, 0.9),
trainer.py:77-78) the first moment is the gradient itself and is not
stored, as in the JAX package's mu-free specialization:

    nu <- (1 - b2) g^2 + b2 nu;  bc2 = 1 - b2^t
    p  <- p + (-lr) * g / (sqrt(nu / bc2) + eps)

Any other b1 (or ``mu_free=False``) follows optax.adam:

    mu <- (1 - b1) g + b1 mu
    p  <- p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / bc2) + eps)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float = 1e-8, mu_free: bool = True):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.mu: Optional[List[torch.Tensor]] = (
            None if (b1 == 0.0 and mu_free)
            else [torch.zeros_like(p) for p in self.params])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (aligned with ``params``)."""
        self.count += 1
        bc2 = 1.0 - self.b2 ** self.count
        bc1 = 1.0 - self.b1 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            nu = self.nu[i]
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            denom = torch.sqrt(nu / bc2) + self.eps
            if self.mu is None:
                upd = g / denom
            else:
                mu = self.mu[i]
                mu.mul_(self.b1).add_(g * (1.0 - self.b1))
                upd = (mu / bc1) / denom
            p.add_(upd * (-self.lr))

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "nu": [t.clone() for t in self.nu],
                "mu": None if self.mu is None
                else [t.clone() for t in self.mu]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if (sd["mu"] is None) != (self.mu is None) or \
                len(sd["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not match this optimizer")
        self.count = int(sd["count"])
        for dst, src in zip(self.nu, sd["nu"]):
            dst.copy_(src)
        if self.mu is not None:
            for dst, src in zip(self.mu, sd["mu"]):
                dst.copy_(src)
