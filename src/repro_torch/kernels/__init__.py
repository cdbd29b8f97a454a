"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version. Sources are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`)."""
