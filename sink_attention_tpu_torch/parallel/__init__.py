"""Training on one device: the loss, the packed-batch loss and the step."""

from .train import (cross_entropy_loss, cross_entropy_loss_packed,
                    make_train_step, param_leaves)

__all__ = ["cross_entropy_loss", "cross_entropy_loss_packed",
           "make_train_step", "param_leaves"]
