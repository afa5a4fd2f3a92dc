"""Optimizers."""
from repro_torch.optim.optimizers import OptState, Optimizer, make_optimizer, sgd

__all__ = ["OptState", "Optimizer", "make_optimizer", "sgd"]
