"""Training loop + fault tolerance."""
from .trainer import StragglerMonitor, Trainer, make_train_step

__all__ = ["StragglerMonitor", "Trainer", "make_train_step"]
