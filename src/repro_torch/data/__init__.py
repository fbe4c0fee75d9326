"""Deterministic synthetic data (a port of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                       SyntheticDataset, make_dataset)

__all__ = ["DataConfig", "Prefetcher", "SyntheticDataset", "make_dataset"]
