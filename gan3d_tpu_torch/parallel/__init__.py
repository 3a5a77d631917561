"""Data parallelism over processes (counterpart of gan3d_tpu/parallel/ for
its 1-D ``data`` mesh): see dist.py."""

from gan3d_tpu_torch.parallel.dist import (ONE, Plan, Replicas, attach, init,
                                           launch, plan, plan_for)

__all__ = ["ONE", "Plan", "Replicas", "attach", "init", "launch", "plan",
           "plan_for"]
