"""Data pipeline: the paper's datasets (synthetic, shape-faithful)."""
from .pipeline import make_iris, make_mnist_like, one_hot_labels, replicate

__all__ = ["make_iris", "make_mnist_like", "one_hot_labels", "replicate"]
