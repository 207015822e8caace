"""Dataflow-selectable GEMM: WS / IS / OS with the fused epilogue (K2)
and the partial-plane spill epilogue (K6).

The paper's §5 schedules one p-GEMM by choosing which operand stays
stationary; ``csrc/mpgemm.cu`` (the port of the reference's Pallas
``mpgemm``) realizes each choice on Hopper:

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

``epilogue="spill"`` keeps the reference's benchmark baseline, the
partial-sum traffic GTA's fused accumulator exists to avoid: K6
(:func:`mpgemm_spill`) writes one fp32 plane per K block under WS/IS
(``(gk, M, N)``, whatever the fold) or one per fold band under OS with
``f > 1`` (``(f, M, N)``), and a torch sum outside the kernel reduces
them.  OS with ``f == 1`` has no planes and runs the fused kernel, as in
the reference.  :func:`dispatch_plan` and :func:`peak_intermediate_bytes`
are the telemetry that shows which of the two a dispatch did.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.tiling import KERNEL_TILES, KSTEP, stream_split
from repro_torch.kernels import _build

EPILOGUES = ("fused", "spill")

#: launches of the CUDA kernel, all dataflows (reset before a run)
launches = _build.LaunchCounter()
#: launches per executed dataflow ("OS", "WS", "IS")
launches_by_dataflow = {"OS": 0, "WS": 0, "IS": 0}
#: launches of the spill kernel (K6), apart from K2's
spill_launches = _build.LaunchCounter()
#: K6 launches per dataflow
spill_launches_by_dataflow = {"OS": 0, "WS": 0, "IS": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "mpgemm_launch": (
        [_I] * 5 + [_P, _L, _L, _P, _L, _L, _P] + [_I] * 6 + [_P], _I),
    "mpgemm_spill_launch": (
        [_I] * 4 + [_P, _L, _L, _P, _L, _L, _P] + [_I] * 6 + [_P], _I)}
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
    """Zero K2's and K6's counts."""
    for counter, by_df in ((launches, launches_by_dataflow),
                           (spill_launches, spill_launches_by_dataflow)):
        counter.reset()
        for k in by_df:
            by_df[k] = 0


def spill_planes(K: int, bk: int, dataflow: Dataflow, k_fold: int) -> int:
    """Planes K6 writes: one per K block (``ceil(K / bk)``) under WS/IS,
    whatever the fold; one per fold band (``effective_fold``) under
    OS/SIMD."""
    gk = max(1, -(-K // bk))
    return gk if dataflow in (Dataflow.WS, Dataflow.IS) else \
        _fold_bands(gk, k_fold)


def _band_sums(a: torch.Tensor, b: torch.Tensor, bk: int,
               planes: int) -> torch.Tensor:
    """(planes, M, N) fp32: plane p sums its run of ``ceil(K / bk) /
    planes`` consecutive K blocks, one ``@`` a block, in K order."""
    gk = max(1, -(-a.shape[1] // bk))
    af, bf = a.float(), b.float()
    out = torch.zeros((planes, a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(gk):
        out[k // (gk // planes)] += af[:, k * bk:(k + 1) * bk] \
            @ bf[k * bk:(k + 1) * bk, :]
    return out


def mpgemm_plain(a: torch.Tensor, b: torch.Tensor, *, bk: int, k_fold: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2: the fp32 sum over the K blocks in the kernel's
    (band, k) order -- K order, whatever ``k_fold`` -- then one cast.  All
    dataflows compute this."""
    return _band_sums(a, b, bk, 1)[0].to(out_dtype)


def mpgemm_spill_plain(a: torch.Tensor, b: torch.Tensor, *,
                       dataflow: Dataflow, bk: int, k_fold: int
                       ) -> torch.Tensor:
    """Plain version of K6: the fp32 plane tensor in the kernel's order,
    ``(spill_planes(...), M, N)`` -- one K block's product a plane under
    WS/IS, one fold band's sum a plane under OS/SIMD."""
    return _band_sums(a, b, bk, spill_planes(a.shape[1], bk, dataflow,
                                             k_fold))


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> None:
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
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mpgemm runs on cuda or cpu, not {a.device}")
    M, K = a.shape
    if a.device.type == "cuda" and min(M, K, b.shape[1]) == 0:
        raise ValueError(f"degenerate GEMM {(M, b.shape[1], K)}")


def mpgemm_spill(a: torch.Tensor, b: torch.Tensor, *,
                 dataflow: Dataflow = Dataflow.WS, bm: int = 64,
                 bn: int = 64, bk: int = 32, k_fold: int = 1
                 ) -> torch.Tensor:
    """K6: the fp32 partial planes of a (M, K) @ b (K, N), as
    :func:`mpgemm_spill_plain` defines them -- launched on CUDA tensors,
    the plain version on CPU tensors.  Operand and tile rules as
    :func:`mpgemm`."""
    _check(a, b, bm, bn, bk)
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    if a.device.type == "cpu":
        return mpgemm_spill_plain(a, b, dataflow=df, bk=bk, k_fold=k_fold)
    M, K = a.shape
    N = b.shape[1]
    f = effective_fold(K, bk, k_fold)
    planes = torch.empty((spill_planes(K, bk, df, f), M, N),
                         dtype=torch.float32, device=a.device)
    _, per = stream_split(M, N, bm, bn, df)
    lib = _build.load("mpgemm", _SIGNATURES)
    rc = lib.mpgemm_spill_launch(
        _DATAFLOW_CODE[df], _DTYPE_CODE[a.dtype], bm, bn,
        a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1), planes.data_ptr(),
        M, N, K, bk, f, per, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, f"mpgemm_spill {df.value} {(M, N, K)}")
    spill_launches.count += 1
    spill_launches_by_dataflow[df.value] += 1
    return planes


def mpgemm(a: torch.Tensor, b: torch.Tensor, *,
           dataflow: Dataflow = Dataflow.OS, bm: int = 64, bn: int = 64,
           bk: int = 32, k_fold: int = 1,
           out_dtype: torch.dtype = torch.float32,
           epilogue: str = "fused") -> torch.Tensor:
    """C = a (M, K) @ b (K, N) with an explicit dataflow schedule.

    ``(bm, bn)`` must be one of ``tiling.KERNEL_TILES`` and ``bk`` a
    multiple of ``tiling.KSTEP``; any M, N, K and any strides are taken.
    The executed fold is ``effective_fold(K, bk, k_fold)``.  SIMD runs the
    OS pipeline (there is no separate vector GEMM unit).
    ``epilogue="spill"`` materializes K6's partial planes and sums them
    (WS/IS always; OS only when the fold is above 1)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {EPILOGUES}")
    _check(a, b, bm, bn, bk)
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    M, K = a.shape
    N = b.shape[1]
    f = effective_fold(K, bk, k_fold)
    if epilogue == "spill" and (df is not Dataflow.OS or f > 1):
        planes = mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                              k_fold=f)
        return planes.sum(0).to(out_dtype)
    if a.device.type == "cpu":
        return mpgemm_plain(a, b, bk=bk, k_fold=f, out_dtype=out_dtype)
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


# ---------------------------------------------------------------------------
# Dispatch telemetry: what one mpgemm dispatch allocates and moves
# ---------------------------------------------------------------------------

def dispatch_plan(M: int, N: int, K: int, *, dataflow: Dataflow,
                  bm: int, bn: int, bk: int, k_fold: int = 1,
                  epilogue: str = "fused",
                  abytes: int = 4, bbytes: int = 4) -> dict:
    """Structural model of one mpgemm dispatch, with the reference's keys.

    Independent of the implementation, and computed with the reference's
    formulas: ``dataflow``, ``epilogue``, ``k_fold_requested``,
    ``k_fold_effective``, ``intermediate_hbm_bytes`` (the fp32 plane
    tensor the dispatch materializes, 0 when fused), ``acc_bytes_per_
    instance`` (one fp32 (bm, bn) accumulator), and the spill path's
    ``out_traffic_bytes``, ``(2 P + 1) M N 4`` (P planes written, read by
    the reduction, the sum written).

    Describing this port's launch (the reference's describe a TPU grid):
      grid               the CUDA grid: (gn, gm) for OS, (gn, gm, f) for
                         OS spill, (gn, chunks) for WS and (gm, chunks)
                         for IS, whose CTAs each stream ``per`` tiles
                         (``tiling.stream_split``);
      grid_steps         (bm, bn, bk) block products over the launch,
                         ``gm gn gk`` on every path;
      hbm_traffic_bytes  operand reads by stationarity (OS re-reads A per
                         N tile and B per M tile; a WS CTA holds its B
                         tiles while its chunk of A streams past, so B is
                         read once per chunk; IS the converse) plus
                         ``out_traffic_bytes``: one write under OS, a
                         store and ``gk - 1`` read-modify-writes of the
                         fp32 output under WS/IS fused, the planes and
                         their reduction under spill.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {EPILOGUES}")
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    if df not in _DATAFLOW_CODE:
        raise ValueError(f"unsupported dataflow {dataflow}")
    gm, gn, gk = -(-M // bm), -(-N // bn), max(1, -(-K // bk))
    f = _fold_bands(gk, k_fold)
    out_once = M * N * 4                     # partials are fp32
    spills = epilogue == "spill" and (df is not Dataflow.OS or f > 1)
    planes = spill_planes(K, bk, df, f) if spills else 0
    ctas, per = stream_split(M, N, bm, bn, df)
    if df is Dataflow.OS:
        grid = (gn, gm, f) if spills else (gn, gm)
        a_traffic, b_traffic = gn * M * K * abytes, gm * K * N * bbytes
    elif df is Dataflow.WS:
        grid = (gn, ctas // gn)
        a_traffic, b_traffic = gn * M * K * abytes, grid[1] * K * N * bbytes
    else:
        grid = (gm, ctas // gm)
        a_traffic, b_traffic = grid[1] * M * K * abytes, gm * K * N * bbytes
    if spills:
        out_traffic = (2 * planes + 1) * out_once
    elif df is Dataflow.OS:
        out_traffic = out_once
    else:
        out_traffic = (2 * gk - 1) * out_once
    return {
        "dataflow": df.value,
        "epilogue": epilogue,
        "grid": grid,
        "grid_steps": gm * gn * gk,
        "k_fold_requested": k_fold,
        "k_fold_effective": f,
        "intermediate_hbm_bytes": planes * out_once,
        "acc_bytes_per_instance": bm * bn * 4,
        "hbm_traffic_bytes": float(a_traffic + b_traffic + out_traffic),
        "out_traffic_bytes": float(out_traffic),
    }


class _LargestOutput(TorchDispatchMode):
    """Records the bytes of the largest tensor an aten op returns (views
    allocate nothing and are not counted)."""

    def __init__(self):
        super().__init__()
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.peak = max(self.peak, t.numel() * t.element_size())
        return out


def peak_intermediate_bytes(fn, *args) -> int:
    """Run ``fn(*args)`` and return the byte size (numel x element size)
    of the largest tensor any aten op produced on the way, on CPU or CUDA
    tensors alike -- the counterpart of the reference's jaxpr walk.  A
    fused dispatch's largest is its output; a spill dispatch's is its
    plane tensor."""
    with _LargestOutput() as mode:
        fn(*args)
    return mode.peak
