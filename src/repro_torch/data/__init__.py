"""Synthetic training data: the heterogeneous subsets and their allocation
to the logical devices."""
from repro_torch.data.synthetic import HeterogeneousLM, linear_regression_problem, lm_batch_for_devices

__all__ = ["HeterogeneousLM", "linear_regression_problem", "lm_batch_for_devices"]
