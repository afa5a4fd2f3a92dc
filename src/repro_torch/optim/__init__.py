"""Optimizers and learning-rate schedules."""
from repro_torch.optim.optimizers import OptState, Optimizer, adamw, make_optimizer, sgd, sgd_momentum
from repro_torch.optim.schedule import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "OptState",
    "Optimizer",
    "adamw",
    "sgd",
    "sgd_momentum",
    "make_optimizer",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
