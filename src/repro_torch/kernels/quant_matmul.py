"""Int8-weight GEMM (K3): ``(x @ float(w_q)) * scale``.

The GTA INT8 serving path: activations stay bf16/fp32, weights are
symmetric per-output-channel int8 (``quant.policy.quantize_tensor``), and
the per-channel scale is applied once, at the flush of the fp32
accumulator.  :func:`quant_matmul` wraps ``csrc/quant_matmul.cu`` (the
port of the reference's Pallas ``quant_matmul``) by one of two routes
that :func:`quant_matmul_route` chooses by a stated rule:

  hopper     bf16 x that TMA can describe: the int8 weight streamed by TMA,
             converted exactly to bf16 in shared memory and fed to wgmma
             (``QUANT_TILES``); where the output has few tiles the K
             stages are split over a cluster, summed through distributed
             shared memory.
  cuda_core  fp32 x (IEEE fp32 FMAs, never TF32) and every other layout
             (``CORE_TILES``; 16-byte weight copies, scalar loads where
             rows cannot be copied in aligned chunks).

:func:`quant_plan` fixes the tile and the cluster split from the shapes
alone.  On CUDA tensors the wrapper launches the route's kernel or
raises; on CPU tensors it runs :func:`quant_matmul_ref`, the plain
version (the reference's ``kernels/ref.py:quant_matmul_ref``).  Any M,
N, K is taken: the kernels mask the edges.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.tiling import HOPPER_STAGE_K, MAX_CLUSTER, NUM_SMS
from repro_torch.kernels import _build

ROUTES = ("hopper", "cuda_core")

#: launches of the CUDA kernels, both routes (reset before a run, read
#: after it)
launches = _build.LaunchCounter()
#: launches per route (``quant_matmul_route``)
launches_by_route = {r: 0 for r in ROUTES}

#: (bm, bn) tiles of the Hopper route, in the output's orientation: bm
#: rows of x by bn weight columns.  The kernel always computes the C^T
#: tile, the bn columns on wgmma's M (64 a consumer warpgroup) and the bm
#: rows on its n; the first four are the decode tiles (M <= DECODE_M).
QUANT_TILES = ((8, 64), (16, 64), (32, 64), (64, 64), (128, 128),
               (256, 128))
#: ring stages of the Hopper kernel (its ``Shape::kStages``)
HOPPER_STAGES = 4
#: (bm, bn) tiles of the CUDA-core route: two wide tiles for M > NARROW_M
#: and the narrow decode tile, with their K stage (BK)
CORE_TILES = ((64, 64), (32, 32), (8, 16))
CORE_BK = {(64, 64): 32, (32, 32): 32, (8, 16): 256}
#: largest M on the Hopper route's decode tiles (a K split is allowed)
DECODE_M = 64
#: largest M on the CUDA-core route's narrow tile
NARROW_M = 16
#: shared memory of one SM (228 KB), which its resident CTAs share
SM_SMEM_BYTES = 233_472

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "quant_matmul_launch": ([_I] * 3 + [_P] * 4 + [_I] * 3 + [_P], _I),
    "quant_matmul_hopper_launch": ([_I] * 3 + [_P, _L, _P, _L, _P, _P]
                                   + [_I] * 3 + [_P], _I)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """One launch of K3: the route, the (bm, bn) tile in the output's
    orientation, and the grid (column tiles, row tiles, ranks) -- on the
    Hopper route ``ranks`` CTAs, one cluster, split each tile's K stages
    in consecutive runs and sum their tiles in rank order."""

    route: str
    tile: tuple[int, int]
    grid: tuple[int, int, int]

    @property
    def ranks(self) -> int:
        return self.grid[2]

    @property
    def tiles(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def ctas(self) -> int:
        return self.tiles * self.ranks


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def hopper_smem_bytes(bm: int, bn: int, ranks: int = 1) -> int:
    """Dynamic shared memory of a Hopper-route launch: 1024 B of alignment
    slack, the ring (int8 weight and bf16 x a stage), three bf16 weight
    buffers, 256 B of mbarriers and, when K is split, the fp32 tile the
    ranks sum through distributed shared memory."""
    ring = HOPPER_STAGES * (bn + bm * 2) * HOPPER_STAGE_K
    return 1024 + ring + 3 * bn * 2 * HOPPER_STAGE_K + 256 \
        + (bm * bn * 4 if ranks > 1 else 0)


def resident_ctas(bm: int, bn: int, ranks: int = 1) -> int:
    """Hopper-route CTAs of one tile that an SM's shared memory holds
    (228 KB, 1 KB of it reserved a CTA)."""
    return SM_SMEM_BYTES // (hopper_smem_bytes(bm, bn, ranks) + 1024)


def _tile(M: int, N: int, route: str) -> tuple[int, int]:
    if route == "hopper":
        if M <= DECODE_M:
            return next(t for t in QUANT_TILES if M <= t[0])
        return next((t for t in QUANT_TILES[5:3:-1]
                     if 2 * _ceil(M, t[0]) * _ceil(N, t[1]) >= NUM_SMS),
                    (64, 64))
    if M <= NARROW_M:
        return 8, 16
    return (64, 64) if _ceil(M, 64) * _ceil(N, 64) >= NUM_SMS else (32, 32)


@functools.lru_cache(maxsize=4096)
def quant_plan(M: int, N: int, K: int, route: str = "hopper",
               tile: tuple[int, int] | None = None) -> QuantPlan:
    """The launch for an (M, N, K) product on ``route``, from the shapes
    alone; ``tile`` overrides the rule's tile (one of the route's tiles).

    Hopper: M <= ``DECODE_M`` takes the smallest decode tile whose bm
    covers M; above, the widest chunk tile that still gives half the SMs
    a tile -- 256 x 128, else 128 x 128, else 64 x 64.  A wider tile
    converts each weight element once for more rows of x.  Timed at the
    int8 path's four (N, K) at 256, 1024 and 2048 rows
    (``launch/quant_tiles.py --tiles``), this rule names the fastest of
    the three at 15 of the 16; at (1024, 896, 4864) 128 x 128 is faster
    than its 64 x 64.  Where the tiles leave SMs idle, the ceil(K / 64) stages are split over the most ranks
    (<= ``MAX_CLUSTER``) that keep tiles x ranks within one wave: two CTAs
    an SM where shared memory holds two with the reduction tile (every
    tile up to 64 x 64), else one.  The 256 x 128 tile has no room for the
    reduction tile and is never split.

    CUDA-core: M <= ``NARROW_M`` takes the narrow 8 x 16 tile (its 256
    threads split each stage's K rows over 32 k-groups); above, 64 x 64
    where it gives every SM a tile, else 32 x 32.  Every CUDA-core CTA
    owns its tile over all of K."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    if min(M, N, K) <= 0:
        raise ValueError(f"degenerate GEMM {(M, N, K)}")
    tiles = QUANT_TILES if route == "hopper" else CORE_TILES
    if tile is None:
        tile = _tile(M, N, route)
    elif tile not in tiles:
        raise ValueError(f"tile {tile} not one of the {route} route's "
                         f"{tiles}")
    gx, gy = _ceil(N, tile[1]), _ceil(M, tile[0])
    ranks = 1
    if route == "hopper" and tile != QUANT_TILES[-1] and gx * gy < NUM_SMS:
        room = NUM_SMS * min(2, resident_ctas(*tile, ranks=2))
        ranks = max(1, min(MAX_CLUSTER, _ceil(K, HOPPER_STAGE_K),
                           room // (gx * gy)))
    return QuantPlan(route, tile, (gx, gy, ranks))


def quant_matmul_route(x: torch.Tensor, w_q: torch.Tensor) -> str:
    """The kernel a CUDA call of ``quant_matmul(x, w_q, scale)`` launches:
    ``"hopper"`` for bf16 x (M, K) with K contiguous and an int8 w_q (K,
    N) with N contiguous whose row strides are multiples of 16 bytes (K a
    multiple of 8, N of 16, for contiguous operands) and cover their rows,
    and whose bases are 16-byte aligned; ``"cuda_core"`` for fp32 x and
    every other layout.  A pure function of the operands' type, strides
    and addresses."""
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or x.dim() != 2 or w_q.dim() != 2:
        return "cuda_core"
    (sx, ux), (sw, uw) = x.stride(), w_q.stride()
    ok = ux == 1 and uw == 1 and sx % 8 == 0 and sw % 16 == 0 \
        and sx >= x.shape[1] and sw >= w_q.shape[1] \
        and (x.data_ptr() | w_q.data_ptr()) % 16 == 0
    return "hopper" if ok else "cuda_core"


def reset_launches() -> None:
    """Zero K3's counts."""
    launches.reset()
    for r in launches_by_route:
        launches_by_route[r] = 0


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


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 *, tile: tuple[int, int] | None = None) -> torch.Tensor:
    """x (M, K) bf16/fp32 @ int8 w_q (K, N), times scale (N,) fp32 ->
    fp32 (M, N): the route's CUDA kernel on CUDA tensors (one launch, no
    device read), the plain version on CPU tensors.  ``tile`` overrides
    ``quant_plan``'s tile (the tile timings use it)."""
    _check(x, w_q, scale)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    M, K = x.shape
    N = w_q.shape[1]
    if min(M, N, K) == 0:
        raise ValueError(f"degenerate GEMM {(M, N, K)}")
    route = quant_matmul_route(x, w_q)
    if not scale.is_contiguous() or (route == "cuda_core" and not (
            x.is_contiguous() and w_q.is_contiguous())):
        raise ValueError("quant_matmul needs contiguous operands off the "
                         "Hopper route")
    plan = quant_plan(M, N, K, route, tile)
    (bm, bn), ranks = plan.tile, plan.ranks
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _build.load("quant_matmul", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "hopper":
        rc = lib.quant_matmul_hopper_launch(
            bm, bn, ranks, x.data_ptr(), x.stride(0), w_q.data_ptr(),
            w_q.stride(0), scale.data_ptr(), out.data_ptr(), M, N, K, stream)
    else:
        rc = lib.quant_matmul_launch(
            _DTYPE_CODE[x.dtype], bm, bn, x.data_ptr(),
            w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K,
            stream)
    _build.check_launch(rc, f"quant_matmul {route} {(M, N, K)} tile "
                            f"{(bm, bn)} x {ranks} ranks")
    launches.count += 1
    launches_by_route[route] += 1
    return out
