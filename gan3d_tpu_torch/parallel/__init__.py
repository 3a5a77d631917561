"""Data and tensor parallelism over processes (counterpart of
gan3d_tpu/parallel/ for its ``data`` and ``model`` mesh axes): the rank
grid in dist.py, the channel sharding in tp.py."""

from gan3d_tpu_torch.parallel.dist import (ONE, Plan, Replicas, attach, grid,
                                           init, launch, plan, plan_for)

__all__ = ["ONE", "Plan", "Replicas", "attach", "grid", "init", "launch",
           "plan", "plan_for"]
