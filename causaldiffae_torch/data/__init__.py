"""Training data: the synthetic pools, the real-data loaders and the batch iterator."""

from .loaders import batch_iterator, load_data
from .synthetic import synthetic_dataset, synthetic_iterator

__all__ = ["batch_iterator", "load_data", "synthetic_dataset", "synthetic_iterator"]
