"""Int8-weight GEMM (K3): ``(x @ float(w_q)) * scale``.

The GTA INT8 serving path: activations stay bf16/fp32, weights are
symmetric per-output-channel int8 (``quant.policy.quantize_tensor``), and
the per-channel scale is applied once, at the flush of the fp32
accumulator.  :func:`quant_matmul` wraps ``csrc/quant_matmul.cu`` (the
port of the reference's Pallas ``quant_matmul``): on CUDA tensors it
launches the kernel or raises; on CPU tensors it runs
:func:`quant_matmul_ref`, the plain version (the reference's
``kernels/ref.py:quant_matmul_ref``).  Any M, N, K is taken: the kernel
masks the edges.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import _build

#: launches of the CUDA kernel (reset before a run, read after it)
launches = _build.LaunchCounter()

#: (bm, bn) of the tiles compiled into csrc/quant_matmul.cu, in the order
#: of its ``tile`` argument: two wide tiles for M > 16, three narrow ones
#: (8 rows) for decode
TILES = ((64, 64), (32, 32), (8, 16), (8, 8), (8, 4))
#: largest M that takes a narrow tile
NARROW_M = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"quant_matmul_launch": ([_I, _I] + [_P] * 4 + [_I] * 3
                                       + [_P], _I)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tile_for(M: int, N: int) -> int:
    """Index into :data:`TILES` of the launch for an (M, N) output: the
    first tile of its family that puts at least one CTA on each of the
    132 SMs, else the family's smallest."""
    family = (2, 3, 4) if M <= NARROW_M else (0, 1)
    for t in family:
        bm, bn = TILES[t]
        if -(-M // bm) * -(-N // bn) >= NUM_SMS:
            return t
    return family[-1]


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x and w_q to fp32, one fp32 matmul, times the
    per-channel scale -> fp32 (M, N)."""
    return (x.float() @ w_q.float()) * scale.float()[None, :]


def _check(x, w_q, scale) -> None:
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul needs x (M, K) and w_q (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    if scale.shape != (w_q.shape[1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match N = "
                         f"{w_q.shape[1]}")
    if x.dtype not in _DTYPE_CODE or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul takes float32/bfloat16 x, int8 w_q "
                        f"and float32 scale, got {x.dtype}, {w_q.dtype}, "
                        f"{scale.dtype}")
    devs = {t.device for t in (x, w_q, scale)}
    if len(devs) != 1:
        raise ValueError(f"quant_matmul operands on several devices: {devs}")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                 ) -> torch.Tensor:
    """x (M, K) bf16/fp32 @ int8 w_q (K, N), times scale (N,) fp32 ->
    fp32 (M, N): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    _check(x, w_q, scale)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, w_q, scale)):
        raise ValueError("quant_matmul needs contiguous operands")
    M, K = x.shape
    N = w_q.shape[1]
    if min(M, N, K) == 0:
        raise ValueError(f"degenerate GEMM {(M, N, K)}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _build.load("quant_matmul", _SIGNATURES)
    rc = lib.quant_matmul_launch(
        _DTYPE_CODE[x.dtype], tile_for(M, N), x.data_ptr(), w_q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), M, N, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, f"quant_matmul {(M, N, K)}")
    launches.count += 1
    return out
