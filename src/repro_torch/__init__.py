"""PyTorch port of the LAD / Com-LAD reproduction, for NVIDIA Hopper.

Runs the protocol round and the Section-VII trainer with hand-written CUDA
kernels for the round's encode, attack, CWTM and NNM-Gram steps
(``repro_torch/csrc``). Importing the package builds nothing; the kernels
compile with ``nvcc`` on their first launch.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
