"""The deterministic synthetic training data of the port."""
from repro_torch.data.pipeline import (DataConfig, batch_logical_axes,
                                       batch_specs, data_iterator,
                                       make_batch, to_device)

__all__ = ["DataConfig", "batch_logical_axes", "batch_specs",
           "data_iterator", "make_batch", "to_device"]
