"""Analytical cycle + memory-traffic simulators: GTA and the paper's three
baselines (VPU=Ara, GPGPU=NVIDIA H100, CGRA=HyCube); a copy of
``repro.core.simulator``, the paper's evaluation model in pure Python.

Methodology (paper §6.3): "We assume the same clock frequency and configure
different number of MPRA to match the same area."  So every comparison is

    cycles(baseline) / cycles(GTA @ area-matched lane count)     -> speedup
    traffic(baseline) / traffic(GTA @ area-matched lane count)   -> mem-eff

with both machines modelled at the same clock.  The two metrics are reported
separately, exactly as the paper does (it never couples them through a
bandwidth roofline).

Area matching (documented re-derivations — the paper's own normalization is
not fully specified):
  * Ara: 4 lanes, 0.33 mm² vs 4-lane GTA 0.35 mm² at 14 nm -> equal by
    construction (the paper's synthesis result).  GTA lane area ~0.0875 mm².
  * H100: 814 mm² @ 4nm ~ 9971 mm² @ 14nm-equivalent (x(14/4)² density).
    Tensor-core area is ~15% of the die (SM datapath share); the GTA that
    fills the same compute silicon is ~9971*0.15/0.0875 ~ 17k lanes.  CUDA
    cores (vector path) get their own ~10% share.
  * HyCube: 7.82 mm² @ 28nm ~ 1.96 mm² @ 14nm; ~60% is PE+interconnect
    fabric -> GTA equivalent ~13 lanes.

"Memory access" counts operand movement between the storage hierarchy and
the compute units (the paper's metric — it charges Tensor Core fragment
re-fetches, VPU chaining re-reads, and GTA stream/spill traffic alike).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from repro_torch.core import pgemm as P
from repro_torch.core.pgemm import Operator, PGEMM, VectorOp
from repro_torch.core.precision import Precision
from repro_torch.core.scheduler import GTAConfig, explore


def _CEIL(a, b):
    return -(-a // b)


GTA_LANE_AREA_MM2 = 0.35 / 4          # paper: 4-lane GTA = 0.35 mm² @ 14nm
H100_AREA_MM2_14NM = 814.0 * (14 / 4) ** 2
H100_TC_FRACTION = 0.15               # tensor-core share of die compute area
H100_CUDA_FRACTION = 0.10             # CUDA-core share
HYCUBE_AREA_MM2_14NM = 7.82 * (14 / 28) ** 2
HYCUBE_FABRIC_FRACTION = 0.60

GPGPU_EQUIV_LANES = int(H100_AREA_MM2_14NM * H100_TC_FRACTION / GTA_LANE_AREA_MM2)
CGRA_EQUIV_LANES = max(1, int(HYCUBE_AREA_MM2_14NM * HYCUBE_FABRIC_FRACTION
                              / GTA_LANE_AREA_MM2))


@dataclasses.dataclass(frozen=True)
class SimResult:
    name: str
    cycles: float
    traffic_bytes: float

    def scaled(self, c: float, t: float) -> "SimResult":
        return SimResult(self.name, self.cycles + c, self.traffic_bytes + t)


class _Platform:
    name = "abstract"

    def run_pgemm(self, op: PGEMM) -> tuple[float, float]:
        raise NotImplementedError

    def run_vector(self, op: VectorOp) -> tuple[float, float]:
        raise NotImplementedError

    def run(self, ops: Sequence[Operator]) -> SimResult:
        cyc = mem = 0.0
        gemms, vecs = P.split_paths(ops)
        for g in gemms:
            c, t = self.run_pgemm(g)
            cyc, mem = cyc + c, mem + t
        for v in vecs:
            c, t = self.run_vector(v)
            cyc, mem = cyc + c, mem + t
        return SimResult(self.name, cyc, mem)


# ---------------------------------------------------------------------------
# GTA
# ---------------------------------------------------------------------------

class GTASim(_Platform):
    """GTA: p-GEMMs via the §5 scheduling explorer, vector ops in SIMD mode.

    Configs beyond 64 lanes execute as ``groups`` mask-partitioned sub-arrays
    (paper §4.2): the workload's most parallel dimension (batch, else M,
    else N) is split across groups; every group loads its own stationary
    tile, so traffic multiplies by ``groups`` for the per-group model while
    cycles divide (parallel execution).
    """

    def __init__(self, config: GTAConfig | None = None):
        self.config = config or GTAConfig(lanes=4)
        self.name = f"GTA-{self.config.lanes}L"

    @staticmethod
    def _split(op: PGEMM, g: int) -> PGEMM | None:
        """Split the parallel dimensions (batch, then M x N jointly) across
        g groups (None if the workload cannot feed g groups)."""
        if g == 1:
            return op
        if op.batch >= g:
            return op.scaled(batch=_CEIL(op.batch, g))
        # 2-D split over the spatial output dims, largest dim first; don't
        # shred a dim below a sublane-worth (8) of elements.
        gm = min(g, max(1, op.M // 8))
        gn = min(_CEIL(g, gm), max(1, op.N // 8))
        if gm * gn * op.batch >= g:
            return op.scaled(M=_CEIL(op.M, gm), N=_CEIL(op.N, gn),
                             batch=max(1, op.batch // max(1, _CEIL(g, gm * gn))))
        return None

    def run_pgemm(self, op: PGEMM) -> tuple[float, float]:
        """The group count is itself a scheduling decision (how many mask
        sub-regions to carve, §4.2): enumerate powers of two up to the
        physical group count, keep the fastest, and break near-ties (within
        5% of min cycles) on traffic.  (The Σ-squares rule remains the
        *within-machine* dataflow/tiling choice inside ``explore``; carving
        the machine is a throughput decision — idle groups help nothing.)"""
        max_g = self.config.groups
        cands: list[tuple[float, float]] = []
        g = 1
        while g <= max_g:
            sub = self._split(op, g)
            if sub is not None:
                choice = explore(sub, self.config)
                cands.append((choice.cycles, choice.traffic_bytes * g))
            g *= 2
        if not cands:
            choice = explore(op, self.config)
            cands = [(choice.cycles, choice.traffic_bytes)]
        min_c = min(c for c, _ in cands)
        near = [ct for ct in cands if ct[0] <= 1.05 * min_c]
        return min(near, key=lambda ct: ct[1])

    def run_vector(self, op: VectorOp) -> tuple[float, float]:
        l = op.precision.limbs
        mults_per_cycle = max(1, self.config.total_pes // (l * l))
        cycles = _CEIL(op.flops, mults_per_cycle)
        return float(cycles), float(op.min_bytes)


# ---------------------------------------------------------------------------
# VPU (Ara)
# ---------------------------------------------------------------------------

class VPUSim(_Platform):
    """Ara-like VPU: per lane one 64-bit-wide unit per precision
    (=> 64/bits MACs/cycle/lane); GEMM runs as chained FMA loops.

    Reuse model (paper §7.2: 'chaining exhibits weaker data reuse'): the
    streamed B panel is re-read once per register-blocked row group
    (``reg_block`` output rows held in vector registers), A scalars stream
    once per column chunk, outputs write once.  Max vector length bounds the
    strip size and thus chaining efficiency.
    """

    def __init__(self, lanes: int = 4, datapath_bits: int = 64,
                 max_vl_bytes: int = 2048, reg_block: int = 8):
        self.lanes = lanes
        self.datapath_bits = datapath_bits
        self.max_vl_bytes = max_vl_bytes
        self.reg_block = reg_block
        self.name = "VPU-Ara"

    def _rate(self, p: Precision) -> int:
        return max(1, self.lanes * self.datapath_bits // p.bits)

    def run_pgemm(self, op: PGEMM) -> tuple[float, float]:
        rate = self._rate(op.precision)
        eb = op.precision.bytes
        cycles = _CEIL(op.macs, rate)
        # operand movement (the paper's metric): a vector datapath has no
        # in-datapath operand reuse — every MAC pulls both operands from the
        # register file / memory hierarchy; chaining only forwards results
        # (paper §1: 'the computing unit cannot exploit data reuse in tensor
        # operators, resulting in a lot of access to storage').
        traffic = (2 * op.macs + op.M * op.N * op.batch) * eb
        return float(cycles), float(traffic)

    def run_vector(self, op: VectorOp) -> tuple[float, float]:
        rate = self._rate(op.precision)
        return float(_CEIL(op.flops, rate)), float(op.min_bytes)


# ---------------------------------------------------------------------------
# GPGPU (H100): Tensor Cores for p-GEMM + CUDA cores for vector ops
# ---------------------------------------------------------------------------

class GPGPUSim(_Platform):
    """H100: p-GEMM on tensor cores, vector on CUDA cores, die-level rates.

    Tensor-core rate per cycle derived from dense-throughput specs at
    1.755 GHz; fragment shape m16n8k16 gives the paper's 'small cube' —
    operands are re-fetched per fragment ring from on-chip storage, and
    workloads that don't fill fragments waste lanes.  Precisions without TC
    support run at the closest higher-precision rate (paper §6.3).
    """

    FRAG_M, FRAG_N, FRAG_K = 16, 8, 16
    FREQ_GHZ = 1.755
    #: dense MACs/s by precision (spec TFLOPs / 2 flops-per-MAC) * 1e12
    _MACS_PER_S = {
        "INT8": 1979.0e12 / 2,
        "FP16": 989.5e12 / 2, "BP16": 989.5e12 / 2,
        "INT16": 989.5e12 / 2,           # no INT16 TC: FP16-rate path
        "FP32": 494.7e12 / 2,            # TF32 tensor path
        "INT32": 494.7e12 / 2,           # closest higher precision
        "FP64": 66.9e12 / 2,
        "INT64": 66.9e12 / 4,            # emulated via FP64/IMAD pipes
    }

    def __init__(self):
        self.name = "GPGPU-H100"

    def _tc_macs_per_cycle(self, p: Precision) -> float:
        return self._MACS_PER_S[p.name] / (self.FREQ_GHZ * 1e9)

    def run_pgemm(self, op: PGEMM) -> tuple[float, float]:
        rate = self._tc_macs_per_cycle(op.precision)
        # fragment-fit utilization: padded to fragment multiples
        um = op.M / (_CEIL(op.M, self.FRAG_M) * self.FRAG_M)
        un = op.N / (_CEIL(op.N, self.FRAG_N) * self.FRAG_N)
        uk = op.K / (_CEIL(op.K, self.FRAG_K) * self.FRAG_K)
        util = um * un * uk
        cycles = op.macs / max(rate * util, 1e-9)
        eb = op.precision.bytes
        # operand movement (the paper's metric): each fragment pass re-fetches
        # its operand cube from on-chip storage — reuse distance is bounded by
        # the fragment edge, the 'small cube ... large numbers of memory
        # operations and high on-chip memory bandwidth' argument of §7.3.
        a = op.M * op.K * eb * _CEIL(op.N, self.FRAG_N)
        b = op.K * op.N * eb * _CEIL(op.M, self.FRAG_M)
        c = op.M * op.N * eb
        return float(cycles), float((a + b + c) * op.batch)

    def run_vector(self, op: VectorOp) -> tuple[float, float]:
        # 16896 FP32 CUDA cores, 1 FMA/cycle each; wider types run slower.
        flops_per_cycle = 16896 * 2
        scale = max(1.0, op.precision.bits / 32)
        cycles = op.flops * scale / flops_per_cycle
        return float(cycles), float(op.min_bytes)


# ---------------------------------------------------------------------------
# CGRA (HyCube)
# ---------------------------------------------------------------------------

class CGRASim(_Platform):
    """HyCube: 4x4 word-level FUs, single-cycle multi-hop NoC.  Word-level
    reconfigurability = full-width datapaths per FU (the area cost the paper
    criticizes); the tiny array bounds spatial reuse to ~4 and typical
    mappings leave PEs idle (paper §7.4)."""

    def __init__(self, rows: int = 4, cols: int = 4, mapping_util: float = 0.55):
        self.rows, self.cols = rows, cols
        self.mapping_util = mapping_util
        self.name = "CGRA-hycube"

    def run_pgemm(self, op: PGEMM) -> tuple[float, float]:
        pes = self.rows * self.cols
        eff = pes * self.mapping_util
        # FUs are 32-bit; wider multiplies take quadratic extra initiation
        scale = max(1.0, (op.precision.bits / 32) ** 2)
        cycles = op.macs * scale / eff
        eb = op.precision.bytes
        a = op.M * op.K * eb * _CEIL(op.N, self.cols)
        b = op.K * op.N * eb * _CEIL(op.M, self.rows)
        c = op.M * op.N * eb
        return float(cycles), float((a + b + c) * op.batch)

    def run_vector(self, op: VectorOp) -> tuple[float, float]:
        pes = self.rows * self.cols
        scale = max(1.0, op.precision.bits / 32)
        cycles = op.flops * scale / (pes * self.mapping_util)
        return float(cycles), float(op.min_bytes)


# ---------------------------------------------------------------------------
# Comparison (area-parity GTA per baseline)
# ---------------------------------------------------------------------------

BASELINES = ("VPU-Ara", "GPGPU-H100", "CGRA-hycube")

#: GTA lane count matching each baseline's compute area (see module doc).
PARITY_LANES: dict[str, int] = {
    "VPU-Ara": 4,
    "GPGPU-H100": GPGPU_EQUIV_LANES,
    "CGRA-hycube": CGRA_EQUIV_LANES,
}


def _baseline(name: str) -> _Platform:
    if name == "VPU-Ara":
        return VPUSim()
    if name == "GPGPU-H100":
        return GPGPUSim()
    if name == "CGRA-hycube":
        return CGRASim()
    raise KeyError(name)


def compare_vs(baseline: str, ops: Sequence[Operator]
               ) -> tuple[SimResult, SimResult]:
    """(GTA@area-parity result, baseline result) for one workload."""
    gta = GTASim(GTAConfig(lanes=PARITY_LANES[baseline]))
    return gta.run(ops), _baseline(baseline).run(ops)


def speedup_and_mem_eff(gta: SimResult, base: SimResult) -> tuple[float, float]:
    """(cycle speedup, memory-traffic efficiency) of GTA over the baseline
    at the paper's same-clock assumption."""
    return (base.cycles / max(gta.cycles, 1e-12),
            base.traffic_bytes / max(gta.traffic_bytes, 1e-12))
