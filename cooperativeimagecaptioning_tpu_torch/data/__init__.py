"""Data layer: cocotalk json/h5 readers, feature stores, batcher, prefetcher.

The port's own copies of the JAX package's host-side loader and datasets.
`DataLoader` and the datasets yield numpy batches and import only numpy and
the standard library; the Trainer and the Evaluator turn each batch into
tensors on their device."""

from cooperativeimagecaptioning_tpu_torch.data.loader import DataLoader  # noqa: F401
from cooperativeimagecaptioning_tpu_torch.data.sources import (  # noqa: F401
    DirFeatureSource, FileDataset, LmdbFeatureSource, SyntheticDataset,
    open_feature_source)
