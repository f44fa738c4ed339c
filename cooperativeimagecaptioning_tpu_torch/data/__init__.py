"""Data layer: the JAX package's host-side loader and datasets, shared as
is (cocotalk json/h5 readers, feature stores, the batcher).

`DataLoader` and `SyntheticDataset` yield numpy batches; their modules
(data/loader.py, data/sources.py) import only numpy and the standard
library, never JAX, so the port and the card's machine use them unchanged.
The Trainer turns each batch into tensors on its device."""

from cooperativeimagecaptioning_tpu.data.loader import DataLoader
from cooperativeimagecaptioning_tpu.data.sources import SyntheticDataset

__all__ = ["DataLoader", "SyntheticDataset"]
