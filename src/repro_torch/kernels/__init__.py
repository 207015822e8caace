"""Hand-written CUDA kernels for Hopper and their wrappers.

``paged_attention`` (K1, paged-decode attention) and ``mpgemm`` (K2, the
dataflow-scheduled GEMM) each hold a plain PyTorch version beside the
wrapper of the CUDA source in ``csrc/``; ``ops`` is the schedule-driven
GEMM layer over K2.  Kernels are built at first use (``_build``).
"""
