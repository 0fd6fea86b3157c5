"""Checkpoints of the port: the atomic, versioned ``CheckpointManager``
and the KV-pool checkpoint stream ``PoolCheckpoint``."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.pool_checkpoint import PoolCheckpoint

__all__ = ["CheckpointManager", "PoolCheckpoint"]
