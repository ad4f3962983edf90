"""Hand-written CUDA kernels of the port, one per Pallas kernel of the
reference package that the port's paths reach, each beside its plain
PyTorch version.  Dispatch policy: ``repro_torch.kernels.ops``; build:
``repro_torch.kernels.build``."""
