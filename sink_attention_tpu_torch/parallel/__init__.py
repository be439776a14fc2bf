"""Training on one device: next-token loss and the training step."""

from .train import cross_entropy_loss, make_train_step, param_leaves

__all__ = ["cross_entropy_loss", "make_train_step", "param_leaves"]
