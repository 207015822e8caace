"""Hand-written CUDA kernels for Hopper and their wrappers.

``paged_attention`` (K1 and K1-int8, paged-decode attention), ``mpgemm``
(K2, the dataflow-scheduled GEMM, and K6, its partial-plane spill
epilogue), ``quant_matmul`` (K3, the int8-weight GEMM), ``limb_gemm``
(K4, the limb GEMM of the exact integer product) and ``ssd`` (K5, the
Mamba2 SSD intra-chunk term) each hold a plain PyTorch version beside the
wrapper of the CUDA source in ``csrc/``; ``accumulator`` recombines K4's
diagonals in the plain composition (on the card K4's fused entry folds
them itself); ``ops`` is the GEMM layer over them.  Kernels are built at
first use (``_build``).

K2's fused epilogue reduces partial sums in the kernel, so no
intermediate tensor exists.  bf16 operands TMA can describe take the
Hopper route (``mpgemm.mpgemm_route``): every CTA keeps its tile's
accumulator in registers over its K range and writes the output once;
OS fold bands split over a cluster are summed through distributed shared
memory.  fp32 and other layouts take the CUDA-core kernels, whose WS/IS
add each (K block, tile) product into an fp32 output.
``epilogue="spill"`` keeps the reference's baseline for benchmarking: K6
writes a ``(gk, M, N)`` (WS/IS) or ``(f, M, N)`` (OS, fold above 1) fp32
plane tensor and a sum reduces it; ``mpgemm.dispatch_plan`` and
``mpgemm.peak_intermediate_bytes`` show which one a dispatch took.
"""
