"""Data pipeline: the paper's datasets (synthetic, shape-faithful) and
the LM token streams."""
from .pipeline import (TokenPipeline, make_iris, make_mnist_like,
                       one_hot_labels, replicate, stub_frontend_batch)

__all__ = ["TokenPipeline", "make_iris", "make_mnist_like", "one_hot_labels",
           "replicate", "stub_frontend_batch"]
