"""The kernels of the protocol round: CUDA sources in ``csrc/``, wrappers in
``ops``, plain PyTorch versions in ``ref``."""
