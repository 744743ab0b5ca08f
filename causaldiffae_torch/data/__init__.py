"""Training data: the synthetic morphomnist pool and its batch iterator."""

from .synthetic import batch_iterator, synthetic_dataset, synthetic_iterator

__all__ = ["batch_iterator", "synthetic_dataset", "synthetic_iterator"]
