"""Multi-process parallelism on ``torch.distributed``: the edge-sharded
global bundle adjustment with a distributed Schur reduction, and the
process-group checks that data-parallel training shares with it.

Counterpart of the JAX package's ``parallel/``: where the JAX package takes
a ``jax.sharding.Mesh`` with a ``"ba"`` (or ``"dp"``) axis, the port takes a
``torch.distributed`` process group; one rank is one shard, on that rank's
own device."""

from .groups import check_device
from .sharded_ba import ShardedBAPlan, sharded_ba_iteration, sharded_ba_solve

__all__ = ["ShardedBAPlan", "check_device", "sharded_ba_iteration", "sharded_ba_solve"]
