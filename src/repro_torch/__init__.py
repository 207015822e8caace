"""PyTorch/CUDA port of the GTA reproduction (the JAX package ``repro``
stays the reference).

The port's first slice serves decoder LMs greedily through the paged
continuous-batching engine, with the paged-decode attention and the
dataflow-scheduled GEMM written by hand in CUDA for Hopper
(``repro_torch.kernels``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
