"""Hand-written CUDA kernels for Hopper and their wrappers.

``paged_attention`` (K1 and K1-int8, paged-decode attention), ``mpgemm``
(K2, the dataflow-scheduled GEMM), ``quant_matmul`` (K3, the int8-weight
GEMM), ``limb_gemm`` (K4, the limb GEMM of the exact integer product) and
``ssd`` (K5, the Mamba2 SSD intra-chunk term) each hold a plain
PyTorch version beside the wrapper of the CUDA source in ``csrc/``;
``accumulator`` recombines K4's diagonals; ``ops`` is the GEMM layer over
them.  Kernels are built at first use (``_build``).
"""
