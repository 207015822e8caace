"""Dataflow-selectable GEMM (K2): WS / IS / OS with the fused epilogue.

The paper's §5 schedules one p-GEMM by choosing which operand stays
stationary; ``csrc/mpgemm.cu`` (the port of the reference's Pallas
``mpgemm``, fused epilogue) realizes each choice on Hopper:

  OS  one CTA per output tile, the fp32 accumulator in registers across
      all fold bands and K steps, one cast at the end;
  WS  the B (weight) tile of a (band, k) step stays in shared memory while
      the CTA streams its chunk of M tiles, adding into an fp32 output;
  IS  the A (input) tile stays while the CTA streams its chunk of N tiles.

``k_fold`` splits the K blocks into ``f`` bands (``effective_fold``
degrades an unrealizable request to the largest divisor of the K grid),
so the band boundary the scheduler costs is explicit in the loop.  Every
output element is summed by one thread in a fixed order, with no atomics.

:func:`mpgemm` launches the kernel on CUDA tensors and runs
:func:`mpgemm_plain` -- the same block-wise fp32 sums in PyTorch -- on CPU
tensors.  Shapes need not be block multiples: the kernel masks the edges.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.tiling import KERNEL_TILES, KSTEP, stream_split
from repro_torch.kernels import _build

#: launches of the CUDA kernel, all dataflows (reset before a run)
launches = _build.LaunchCounter()
#: launches per executed dataflow ("OS", "WS", "IS")
launches_by_dataflow = {"OS": 0, "WS": 0, "IS": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {"mpgemm_launch": (
    [_I] * 5 + [_P, _L, _L, _P, _L, _L, _P] + [_I] * 6 + [_P], _I)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DATAFLOW_CODE = {Dataflow.OS: 0, Dataflow.WS: 1, Dataflow.IS: 2}


def _fold_bands(gk: int, k_fold: int) -> int:
    """Largest divisor of ``gk`` not exceeding the requested fold."""
    f = max(1, min(k_fold, gk))
    while gk % f:
        f -= 1
    return f


def effective_fold(K: int, bk: int, k_fold: int) -> int:
    """The fold the kernel executes for a contraction of ``K`` at block
    size ``bk``: bands must tile the K grid ``ceil(K / bk)`` evenly."""
    return _fold_bands(max(1, -(-K // bk)), k_fold)


def reset_launches() -> None:
    launches.reset()
    for k in launches_by_dataflow:
        launches_by_dataflow[k] = 0


def mpgemm_plain(a: torch.Tensor, b: torch.Tensor, *, bk: int, k_fold: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: the fp32 sum over the K blocks in the kernel's
    (band, k) order, then one cast.  All dataflows compute this."""
    M, K = a.shape
    gk = max(1, -(-K // bk))
    f = _fold_bands(gk, k_fold)
    gkf = gk // f
    af, bf = a.float(), b.float()
    acc = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for fi in range(f):
        for k in range(gkf):
            k0 = (fi * gkf + k) * bk
            acc += af[:, k0:k0 + bk] @ bf[k0:k0 + bk, :]
    return acc.to(out_dtype)


def mpgemm(a: torch.Tensor, b: torch.Tensor, *,
           dataflow: Dataflow = Dataflow.OS, bm: int = 64, bn: int = 64,
           bk: int = 32, k_fold: int = 1,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = a (M, K) @ b (K, N) with an explicit dataflow schedule.

    ``(bm, bn)`` must be one of ``tiling.KERNEL_TILES`` and ``bk`` a
    multiple of ``tiling.KSTEP``; any M, N, K and any strides are taken.
    The executed fold is ``effective_fold(K, bk, k_fold)``.  SIMD runs the
    OS pipeline (there is no separate vector GEMM unit)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mpgemm needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"mpgemm takes float32 or bfloat16 operands of one "
                        f"type, got {a.dtype} and {b.dtype}")
    if (bm, bn) not in KERNEL_TILES or bk % KSTEP or bk <= 0:
        raise ValueError(f"unsupported tile ({bm}, {bn}, {bk}): tiles are "
                         f"{KERNEL_TILES}, bk a multiple of {KSTEP}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    M, K = a.shape
    N = b.shape[1]
    f = effective_fold(K, bk, k_fold)
    if a.device.type == "cpu":
        return mpgemm_plain(a, b, bk=bk, k_fold=f, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm runs on cuda or cpu, not {a.device}")
    if min(M, N, K) == 0:
        raise ValueError(f"degenerate GEMM {(M, N, K)}")
    if df is Dataflow.OS and out_dtype in (a.dtype, torch.float32):
        out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    else:
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _, per = stream_split(M, N, bm, bn, df)
    lib = _build.load("mpgemm", _SIGNATURES)
    rc = lib.mpgemm_launch(
        _DATAFLOW_CODE[df], _DTYPE_CODE[a.dtype],
        int(out.dtype == torch.float32), bm, bn,
        a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
        M, N, K, bk, f, per, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, f"mpgemm {df.value} {(M, N, K)}")
    launches.count += 1
    launches_by_dataflow[df.value] += 1
    return out if out.dtype == out_dtype else out.to(out_dtype)
