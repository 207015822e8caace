"""Systolic dataflow cost models (copy of ``repro.core.dataflow``).

Analytical cycle and memory-traffic models for one p-GEMM on a systolic
array of 8-bit PEs under WS / IS / OS and the SIMD fallback, with the
paper's multi-precision mapping rules (§3.1) and the Uncover/Cover
remedies as schedule variants (``k_fold``, ``direction``).  The schedule
cache runs the paper-§5 selection over these costs; the numbers must be
the reference's exactly so that both caches pick the same schedule for
the same shape, so nothing here is adapted to the GPU.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Iterator

from repro_torch.core.pgemm import PGEMM


class Dataflow(enum.Enum):
    WS = "WS"      # weight stationary
    IS = "IS"      # input stationary
    OS = "OS"      # output stationary
    SIMD = "SIMD"  # vector fallback (no systolic reuse)


class Pattern(enum.Enum):
    """Fig. 5 cases: how the mapped workload covers the array."""

    UNCOVER_1 = "uncover1"
    UNCOVER_2 = "uncover2"
    UNCOVER_3 = "uncover3"
    COVER_2 = "cover2"
    COVER_3 = "cover3"
    COVER_1 = "cover1"


class Direction(enum.Enum):
    LATERAL = "lateral"    # N-major tiling ring
    VERTICAL = "vertical"  # M-major tiling ring


@dataclasses.dataclass(frozen=True)
class ArrayShape:
    """Physical PE array: ``rows x cols`` 8-bit PEs (lanes already merged)."""

    rows: int
    cols: int

    @property
    def pes(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One fully-specified scheduling decision for a p-GEMM."""

    dataflow: Dataflow
    array: ArrayShape
    pattern: Pattern
    k_fold: int = 1
    direction: Direction = Direction.LATERAL


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Cycle count + memory traffic of one schedule."""

    schedule: Schedule
    cycles: float
    traffic_bytes: float
    utilization: float


def spatial_dims(df: Dataflow, op: PGEMM, array: ArrayShape):
    """((dim_r, r_cap), (dim_c, c_cap), time_scale) of the mapping."""
    l = op.precision.limbs
    if df in (Dataflow.WS, Dataflow.IS):
        if df is Dataflow.WS:
            return (op.K, array.rows), (op.N, max(1, array.cols // l)), l
        return (op.K, array.rows), (op.M, max(1, array.cols // l)), l
    if df is Dataflow.OS:
        return (op.M, max(1, array.rows // l)), (op.N, max(1, array.cols // l)), 1
    raise ValueError(f"spatial_dims undefined for {df}")


def match_pattern(df: Dataflow, op: PGEMM, array: ArrayShape) -> Pattern:
    """Classify the workload-vs-array relation (Fig. 5)."""
    (dim_r, r_cap), (dim_c, c_cap), _ = spatial_dims(df, op, array)
    over_r, over_c = dim_r > r_cap, dim_c > c_cap
    if over_r and over_c:
        return Pattern.COVER_1
    if not over_r and not over_c:
        return Pattern.UNCOVER_1
    if over_r:
        return Pattern.COVER_2 if dim_r * dim_c >= r_cap * c_cap else Pattern.UNCOVER_2
    return Pattern.COVER_3 if dim_r * dim_c >= r_cap * c_cap else Pattern.UNCOVER_3


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def cost_ws_is(op: PGEMM, array: ArrayShape, *, input_stationary: bool,
               k_fold: int = 1, direction: Direction = Direction.LATERAL,
               ) -> CostReport:
    """WS/IS cost: the stationary K x S tile (S = N for WS, M for IS) is
    loaded once, the partner streams limb-serially, and fold bands spill
    separate partial sums."""
    df = Dataflow.IS if input_stationary else Dataflow.WS
    l = op.precision.limbs
    eb = op.precision.bytes
    S = op.M if input_stationary else op.N
    T = op.N if input_stationary else op.M

    f = max(1, min(k_fold, max(1, array.cols // l)))
    c_cap = max(1, (array.cols // l) // f)
    r_cap = array.rows

    chunks = _ceil(op.K, r_cap)
    f = min(f, chunks)
    passes_k = _ceil(chunks, f)
    s_tiles = _ceil(S, c_cap)
    n_passes = passes_k * s_tiles

    rows_used = min(op.K, r_cap)
    cols_used = min(S, c_cap) * l * f
    cycles_pass = rows_used + T * l + cols_used - 1
    cycles = n_passes * cycles_pass * op.batch

    stationary_bytes = op.K * S * eb
    stream_bytes = T * op.K * s_tiles * eb
    out_bytes = T * S * eb * (2 * f - 1)
    traffic = (stationary_bytes + stream_bytes + out_bytes) * op.batch

    useful = op.macs * l * l
    util = useful / max(1.0, cycles * array.pes)
    pat = match_pattern(df, op, array)
    return CostReport(Schedule(df, array, pat, f, direction), cycles, traffic,
                      min(1.0, util))


def cost_os(op: PGEMM, array: ArrayShape, *, k_fold: int = 1,
            direction: Direction = Direction.LATERAL) -> CostReport:
    """OS cost: output tiles stay resident while A and B stream; ``k_fold``
    replicates a small output tile across the idle array."""
    l = op.precision.limbs
    eb = op.precision.bytes
    r_cap = max(1, array.rows // l)
    c_cap = max(1, array.cols // l)

    m_tiles = _ceil(op.M, r_cap)
    n_tiles = _ceil(op.N, c_cap)

    f = max(1, k_fold)
    free_factor = max(1, (r_cap * c_cap) // max(1, min(op.M, r_cap) * min(op.N, c_cap)))
    f = min(f, free_factor)

    k_len = _ceil(op.K, f)
    rows_used = min(op.M, r_cap) * l
    cols_used = min(op.N, c_cap) * l
    cycles_tile = k_len + rows_used + cols_used - 2
    n_tile_pairs = m_tiles * n_tiles
    cycles = n_tile_pairs * cycles_tile * op.batch

    if direction is Direction.LATERAL:
        a_bytes = op.M * op.K * eb
        b_bytes = op.K * op.N * eb * m_tiles
    else:
        a_bytes = op.M * op.K * eb * n_tiles
        b_bytes = op.K * op.N * eb
    out_bytes = op.M * op.N * eb * (2 * f - 1)
    traffic = (a_bytes + b_bytes + out_bytes) * op.batch

    useful = op.macs * l * l
    util = useful / max(1.0, cycles * array.pes)
    pat = match_pattern(Dataflow.OS, op, array)
    return CostReport(Schedule(Dataflow.OS, array, pat, f, direction), cycles,
                      traffic, min(1.0, util))


def cost_simd(op: PGEMM, array: ArrayShape) -> CostReport:
    """SIMD fallback: ``PEs / l²`` multipliers, no operand reuse."""
    l = op.precision.limbs
    eb = op.precision.bytes
    mults_per_cycle = max(1, array.pes // (l * l))
    cycles = _ceil(op.macs, mults_per_cycle)
    traffic = (2 * op.macs + op.M * op.N * op.batch) * eb
    util = (op.macs * l * l) / max(1.0, cycles * array.pes)
    pat = match_pattern(Dataflow.OS, op, array)
    return CostReport(Schedule(Dataflow.SIMD, array, pat), cycles, traffic,
                      min(1.0, util))


def candidate_costs(op: PGEMM, array: ArrayShape,
                    k_folds: list[int] | None = None) -> Iterator[CostReport]:
    """The (dataflow x k_fold x direction) space for one array shape, in
    the reference's enumeration order (ties resolve to the first)."""
    if k_folds is None:
        k_folds = [1, 2, 4, 8]
    for f in k_folds:
        for d in (Direction.LATERAL, Direction.VERTICAL):
            yield cost_ws_is(op, array, input_stationary=False, k_fold=f, direction=d)
            yield cost_ws_is(op, array, input_stationary=True, k_fold=f, direction=d)
            yield cost_os(op, array, k_fold=f, direction=d)
    yield cost_simd(op, array)
