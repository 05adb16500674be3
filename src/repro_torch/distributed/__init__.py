"""Distribution of the port over torch.distributed ranks: the sharding
rules (``sharding``) and the compressed cross-pod gradient exchange with
error feedback (``collectives``)."""
from . import collectives, sharding

__all__ = ["collectives", "sharding"]
