"""The port's optimizer: AdamW with decoupled weight decay, global-norm
clipping and the cosine schedule, and the error-feedback gradient
compression of the DP all-reduce (``compress.py``)."""
from repro_torch.optim.adamw import (AdamWState, apply_updates,
                                     clip_by_global_norm, cosine_schedule,
                                     decays, global_norm, init_state)

__all__ = ["AdamWState", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "decays", "global_norm", "init_state"]
