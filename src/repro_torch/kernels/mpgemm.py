"""Dataflow-selectable GEMM: WS / IS / OS with the fused epilogue (K2)
and the partial-plane spill epilogue (K6).

The paper's §5 schedules one p-GEMM by choosing which operand stays
stationary; ``csrc/mpgemm.cu`` (the port of the reference's Pallas
``mpgemm``) realizes each choice on Hopper, by one of two routes that
:func:`mpgemm_route` chooses by a stated rule:

  hopper     bf16 operands TMA can describe: bf16 wgmma fed by TMA through
             an mbarrier ring (``tiling.HOPPER_TILES``; the operands are
             swapped for M <= 64; bk a multiple of 64).  OS splits its fold bands -- or, when
             the output has few tiles, runs of whole K blocks -- over a
             cluster and sums them through distributed shared memory;
             WS / IS own each output tile over all of K and multicast the
             stationary operand (B under WS, A under IS) to a cluster.
             The output is written once, in the output type.
  cuda_core  everything else (fp32, which stays IEEE fp32, and bf16 whose
             layout TMA refuses): the CUDA-core kernels
             (``tiling.KERNEL_TILES``), OS with the accumulator in
             registers, WS / IS with the stationary tile in shared memory
             adding into an fp32 output that the wrapper casts.

``k_fold`` splits the K blocks into ``f`` bands (``effective_fold``
degrades an unrealizable request to the largest divisor of the K grid),
so the band boundary the scheduler costs is explicit in the loop.  Every
output element is summed in a fixed order, with no atomics.

:func:`mpgemm` launches a kernel on CUDA tensors and runs
:func:`mpgemm_plain` -- the same block-wise fp32 sums in PyTorch -- on CPU
tensors.  Shapes need not be block multiples: the kernels mask the edges.

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
from repro_torch.core.tiling import HOPPER_STAGE_K, HOPPER_TILES, \
    KERNEL_TILES, KSTEP, core_tile, hopper_launch, stream_split
from repro_torch.kernels import _build

EPILOGUES = ("fused", "spill")
ROUTES = ("hopper", "cuda_core")

#: launches of the CUDA kernel, all dataflows (reset before a run)
launches = _build.LaunchCounter()
#: launches per executed dataflow ("OS", "WS", "IS")
launches_by_dataflow = {"OS": 0, "WS": 0, "IS": 0}
#: launches of the spill kernel (K6), apart from K2's
spill_launches = _build.LaunchCounter()
#: K6 launches per dataflow
spill_launches_by_dataflow = {"OS": 0, "WS": 0, "IS": 0}
#: K2 launches per route (``mpgemm_route``)
launches_by_route = {r: 0 for r in ROUTES}
#: K6 launches per route
spill_launches_by_route = {r: 0 for r in ROUTES}

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "mpgemm_launch": (
        [_I] * 5 + [_P, _L, _L, _P, _L, _L, _P] + [_I] * 6 + [_P], _I),
    "mpgemm_spill_launch": (
        [_I] * 4 + [_P, _L, _L, _P, _L, _L, _P] + [_I] * 6 + [_P], _I),
    "mpgemm_hopper_launch": (
        [_I] * 3 + [_P, _L, _P, _L, _L, _P] + [_I] * 12 + [_P], _I)}
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
    launches.reset()
    spill_launches.reset()
    for by in (launches_by_dataflow, spill_launches_by_dataflow,
               launches_by_route, spill_launches_by_route):
        for k in by:
            by[k] = 0


def _tma_operand(t: torch.Tensor, k_dim: int, any_unit: bool) -> bool:
    """Whether TMA can describe a 2-D bf16 operand: a unit stride (on the
    K dimension ``k_dim``, or on either when ``any_unit``), the other
    stride x 2 bytes a multiple of 16 and at least its dimension's extent,
    and a 16-byte-aligned base."""
    if t.data_ptr() % 16:
        return False
    for unit in ((k_dim, 1 - k_dim) if any_unit else (k_dim,)):
        other = 1 - unit
        if t.stride(unit) == 1 and (t.stride(other) * 2) % 16 == 0 \
                and t.stride(other) >= t.shape[unit]:
            return True
    return False


def mpgemm_route(a: torch.Tensor, b: torch.Tensor, bk: int) -> str:
    """The kernel a CUDA dispatch of ``a @ b`` at K block ``bk`` launches:
    ``"hopper"`` for bf16 operands that TMA can describe -- A (M, K) with
    K contiguous, B (K, N) with K or N contiguous, the other stride x 2
    bytes a multiple of 16, bases 16-byte aligned -- and a K block of
    whole ring stages (``bk`` a multiple of ``tiling.HOPPER_STAGE_K``);
    ``"cuda_core"`` for everything else (fp32, odd strides, unaligned
    bases).  A pure function of the operands' type, strides and
    addresses and of bk."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or bk % HOPPER_STAGE_K:
        return "cuda_core"
    ok = _tma_operand(a, 1, False) and _tma_operand(b, 0, True)
    return "hopper" if ok else "cuda_core"


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
    if (bm, bn) not in KERNEL_TILES + HOPPER_TILES or bk % KSTEP or bk <= 0:
        raise ValueError(f"unsupported tile ({bm}, {bn}, {bk}): tiles are "
                         f"{sorted(set(KERNEL_TILES + HOPPER_TILES))}, bk a "
                         f"multiple of {KSTEP}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mpgemm runs on cuda or cpu, not {a.device}")
    M, K = a.shape
    if a.device.type == "cuda" and min(M, K, b.shape[1]) == 0:
        raise ValueError(f"degenerate GEMM {(M, b.shape[1], K)}")


def _launch_hopper(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                   df: Dataflow, bm: int, bn: int, bk: int, f: int,
                   spill: bool) -> None:
    """One Hopper-route launch into ``out``: C (M, N) in bf16 or fp32, or
    the fp32 planes when ``spill``."""
    M, K = a.shape
    N = b.shape[1]
    g = hopper_launch(M, N, K, df, bm, bn, bk, f, spill)
    epi = 2 if spill else int(out.dtype == torch.float32)
    lib = _build.load("mpgemm", _SIGNATURES)
    rc = lib.mpgemm_hopper_launch(
        epi, bm, bn, a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        b.stride(1), out.data_ptr(), M, N, K, bk, g.tiles_p, g.tiles_q,
        g.grid_p, g.grid_q, g.units, g.zsplit, g.mc, g.csize,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, f"mpgemm hopper {df.value} {(M, N, K)} tile "
                            f"{(bm, bn)}")


def mpgemm_spill(a: torch.Tensor, b: torch.Tensor, *,
                 dataflow: Dataflow = Dataflow.WS, bm: int = 64,
                 bn: int = 64, bk: int = 32, k_fold: int = 1
                 ) -> torch.Tensor:
    """K6: the fp32 partial planes of a (M, K) @ b (K, N), as
    :func:`mpgemm_spill_plain` defines them -- launched on CUDA tensors
    (the route :func:`mpgemm_route` names), the plain version on CPU
    tensors.  Operand and tile rules as :func:`mpgemm`."""
    _check(a, b, bm, bn, bk)
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    if a.device.type == "cpu":
        return mpgemm_spill_plain(a, b, dataflow=df, bk=bk, k_fold=k_fold)
    M, K = a.shape
    N = b.shape[1]
    f = effective_fold(K, bk, k_fold)
    planes = torch.empty((spill_planes(K, bk, df, f), M, N),
                         dtype=torch.float32, device=a.device)
    route = mpgemm_route(a, b, bk)
    if route == "hopper":
        _launch_hopper(a, b, planes, df, bm, bn, bk, f, True)
    else:
        cm, cn = core_tile(bm, bn)
        _, per = stream_split(M, N, cm, cn, df)
        lib = _build.load("mpgemm", _SIGNATURES)
        rc = lib.mpgemm_spill_launch(
            _DATAFLOW_CODE[df], _DTYPE_CODE[a.dtype], cm, cn,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), planes.data_ptr(),
            M, N, K, bk, f, per,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(rc, f"mpgemm_spill {df.value} {(M, N, K)}")
    spill_launches.count += 1
    spill_launches_by_dataflow[df.value] += 1
    spill_launches_by_route[route] += 1
    return planes


def mpgemm(a: torch.Tensor, b: torch.Tensor, *,
           dataflow: Dataflow = Dataflow.OS, bm: int = 64, bn: int = 64,
           bk: int = 32, k_fold: int = 1,
           out_dtype: torch.dtype = torch.float32,
           epilogue: str = "fused") -> torch.Tensor:
    """C = a (M, K) @ b (K, N) with an explicit dataflow schedule.

    ``(bm, bn)`` must be one of ``tiling.HOPPER_TILES`` (which holds
    ``tiling.KERNEL_TILES``) and ``bk`` a multiple of ``tiling.KSTEP``;
    any M, N, K and any strides are taken.  The Hopper route runs the
    tile as given; the CUDA-core route runs ``tiling.core_tile(bm, bn)``.
    The executed fold is ``effective_fold(K, bk, k_fold)``.  SIMD runs the
    OS pipeline (there is no separate vector GEMM unit).  One kernel
    launch a dispatch.  ``epilogue="spill"`` materializes K6's partial
    planes and sums them (WS/IS always; OS only when the fold is above
    1)."""
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
    route = mpgemm_route(a, b, bk)
    if route == "hopper":
        # written once, in the output type (bf16 or fp32)
        direct = out_dtype in (torch.bfloat16, torch.float32)
        out = torch.empty((M, N), dtype=out_dtype if direct else
                          torch.float32, device=a.device)
        _launch_hopper(a, b, out, df, bm, bn, bk, f, False)
    else:
        if df is Dataflow.OS and out_dtype in (a.dtype, torch.float32):
            out = torch.empty((M, N), dtype=out_dtype, device=a.device)
        else:
            out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        cm, cn = core_tile(bm, bn)
        _, per = stream_split(M, N, cm, cn, df)
        lib = _build.load("mpgemm", _SIGNATURES)
        rc = lib.mpgemm_launch(
            _DATAFLOW_CODE[df], _DTYPE_CODE[a.dtype],
            int(out.dtype == torch.float32), cm, cn,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
            M, N, K, bk, f, per,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(rc, f"mpgemm {df.value} {(M, N, K)}")
    launches.count += 1
    launches_by_dataflow[df.value] += 1
    launches_by_route[route] += 1
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

    Describing this port's launch (the reference's describe a TPU grid),
    on its ``route``: ``"hopper"`` for 2-byte operands at a Hopper tile
    (taken to be bf16 that TMA can describe, as the models' are),
    ``"cuda_core"`` otherwise:
      grid               the CUDA grid.  Hopper: (grid_p, grid_q, zsplit)
                         of ``tiling.hopper_launch``, with ``cluster`` its
                         cluster shape.  CUDA-core: (gn, gm) for OS, (gn,
                         gm, f) for OS spill, (gn, chunks) for WS and (gm,
                         chunks) for IS, whose CTAs each stream ``per``
                         tiles (``tiling.stream_split``);
      grid_steps         (bm, bn, bk) block products over the launch,
                         ``gm gn gk`` on every path;
      hbm_traffic_bytes  operand reads by stationarity plus
                         ``out_traffic_bytes``.  Hopper: each CTA reads its
                         own operand tile over its K range and the
                         stationary tile is read once per multicast
                         cluster; the output is written once (fused) or
                         the planes are written and reduced (spill).
                         CUDA-core: OS re-reads A per N tile and B per M
                         tile; a WS CTA holds its B tiles while its chunk
                         of A streams past, so B is read once per chunk
                         (IS the converse); the output is written once
                         under OS, stored and read-modify-written ``gk -
                         1`` times in fp32 under WS/IS fused.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {EPILOGUES}")
    df = Dataflow.OS if dataflow is Dataflow.SIMD else dataflow
    if df not in _DATAFLOW_CODE:
        raise ValueError(f"unsupported dataflow {dataflow}")
    route = "hopper" if abytes == bbytes == 2 and \
        (bm, bn) in HOPPER_TILES else "cuda_core"
    gm, gn, gk = -(-M // bm), -(-N // bn), max(1, -(-K // bk))
    f = _fold_bands(gk, k_fold)
    out_once = M * N * 4                     # partials are fp32
    spills = epilogue == "spill" and (df is not Dataflow.OS or f > 1)
    planes = spill_planes(K, bk, df, f) if spills else 0
    extra = {}
    if route == "hopper":
        g = hopper_launch(M, N, K, df, bm, bn, bk, f, spills)
        grid = g.grid
        extra["cluster"] = g.cluster
        p_readers = g.grid_q // g.csize if g.mc == 2 else g.grid_q
        q_readers = g.grid_p // g.csize if g.mc == 1 else g.grid_p
        pb, qb = (bbytes, abytes) if g.swap else (abytes, bbytes)
        rows_p, rows_q = (N, M) if g.swap else (M, N)
        p_traffic = p_readers * rows_p * K * pb
        q_traffic = q_readers * rows_q * K * qb
        a_traffic, b_traffic = (q_traffic, p_traffic) if g.swap else \
            (p_traffic, q_traffic)
    else:
        cm, cn = core_tile(bm, bn) if (bm, bn) in HOPPER_TILES \
            else (bm, bn)
        cgm, cgn = -(-M // cm), -(-N // cn)
        ctas, per = stream_split(M, N, cm, cn, df)
        if df is Dataflow.OS:
            grid = (cgn, cgm, f) if spills else (cgn, cgm)
            a_traffic, b_traffic = cgn * M * K * abytes, cgm * K * N * bbytes
        elif df is Dataflow.WS:
            grid = (cgn, ctas // cgn)
            a_traffic = cgn * M * K * abytes
            b_traffic = grid[1] * K * N * bbytes
        else:
            grid = (cgm, ctas // cgm)
            a_traffic = grid[1] * M * K * abytes
            b_traffic = cgm * K * N * bbytes
    if spills:
        out_traffic = (2 * planes + 1) * out_once
    elif df is Dataflow.OS or route == "hopper":
        out_traffic = out_once
    else:
        out_traffic = (2 * gk - 1) * out_once
    return {
        "dataflow": df.value,
        "epilogue": epilogue,
        "route": route,
        "grid": grid,
        **extra,
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
