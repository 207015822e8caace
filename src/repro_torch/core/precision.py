"""Precision formats and limb algebra (copy of ``repro.core.precision``,
paper §3.1).

A ``w``-bit multiplication decomposes into ``l = ceil(w / 8)`` 8-bit limbs
whose cross-products follow the dataflow of a small matrix product; the
MPRA occupancy rules and the Table-3 SIMD gains below derive from that
count.  The schedule cache keys every GEMM by the GTA precision of its
operands, so the port maps dtypes to the same names as the reference, or
the two caches would split.
"""

from __future__ import annotations

import dataclasses
import enum
import math

PE_BITS = 8  # paper's basic PE precision


class PClass(enum.Enum):
    INT = "int"
    FLOAT = "float"


@dataclasses.dataclass(frozen=True)
class Precision:
    """A computational precision as GTA sees it: storage ``bits``, the
    multiplier width ``mult_bits`` (mantissa incl. implicit bit for
    floats) and its class."""

    name: str
    bits: int
    mult_bits: int
    pclass: PClass

    @property
    def limbs(self) -> int:
        """Number of 8-bit limbs a single multiplication decomposes into."""
        return max(1, math.ceil(self.mult_bits / PE_BITS))

    @property
    def bytes(self) -> int:
        return self.bits // 8

    @property
    def is_float(self) -> bool:
        return self.pclass is PClass.FLOAT

    def __str__(self) -> str:
        return self.name


INT8 = Precision("INT8", 8, 8, PClass.INT)
INT16 = Precision("INT16", 16, 16, PClass.INT)
INT32 = Precision("INT32", 32, 32, PClass.INT)
INT64 = Precision("INT64", 64, 64, PClass.INT)
BP16 = Precision("BP16", 16, 8, PClass.FLOAT)    # bfloat16: 8-bit mantissa
FP16 = Precision("FP16", 16, 12, PClass.FLOAT)   # paper pads 11 -> 12
FP32 = Precision("FP32", 32, 24, PClass.FLOAT)
FP64 = Precision("FP64", 64, 53, PClass.FLOAT)

ALL_PRECISIONS = (INT8, INT16, INT32, INT64, BP16, FP16, FP32, FP64)
BY_NAME: dict[str, Precision] = {p.name: p for p in ALL_PRECISIONS}

_DTYPE_TO_NAME = {"int8": "INT8", "int16": "INT16", "int32": "INT32",
                  "int64": "INT64", "bfloat16": "BP16", "float16": "FP16",
                  "float32": "FP32", "float64": "FP64"}


def precision_for_dtype(dtype, default: str | None = None) -> Precision:
    """GTA precision for a torch dtype or a dtype name (``"bfloat16"``).
    Unknown dtypes raise unless ``default`` names a fallback."""
    key = str(dtype).removeprefix("torch.")
    name = _DTYPE_TO_NAME.get(key, default)
    if name is None:
        raise ValueError(f"no GTA precision for dtype {dtype}")
    return BY_NAME[name]


def precision(name: str) -> Precision:
    """Look up a precision by (case-insensitive) name; ``BF16`` is an
    alias of ``BP16``."""
    key = name.upper().replace("BF16", "BP16")
    if key not in BY_NAME:
        raise KeyError(f"unknown precision {name!r}; known: {sorted(BY_NAME)}")
    return BY_NAME[key]


# ---------------------------------------------------------------------------
# MPRA occupancy rules (paper §3.1 / §4.1)
# ---------------------------------------------------------------------------

def ws_row_expansion(p: Precision) -> int:
    """WS/IS: a p-bit stationary operand occupies this many PEs along a
    row (its limbs in consecutive positions, Fig. 1a)."""
    return p.limbs


def os_expansion(p: Precision) -> int:
    """OS: the mapped workload expands by this factor in both array
    directions (both operands limb-decomposed spatially, Fig. 1b)."""
    return p.limbs


def vector_pes_per_mult(p: Precision) -> int:
    """SIMD: one p-bit multiply consumes l*l PEs in one step."""
    return p.limbs * p.limbs


def simd_gain(p: Precision, mpra_pes: int = 64,
              vpu_datapath_bits: int = 64) -> float:
    """Table 3: throughput of one MPRA lane (``mpra_pes`` 8-bit PEs, l*l
    of them per multiply) over one VPU lane (``vpu_datapath_bits /
    p.bits`` multiplies a cycle): INT8 8x, INT16 4x, INT32 2x, INT64 1x,
    BP16 16x, FP16 4x, FP32 3.56x, FP64 1.31x."""
    vpu_rate = vpu_datapath_bits / p.bits
    mpra_rate = mpra_pes / vector_pes_per_mult(p)
    return mpra_rate / vpu_rate


# ---------------------------------------------------------------------------
# Limb decomposition / recomposition algebra
# ---------------------------------------------------------------------------

def limb_count(total_bits: int, limb_bits: int = PE_BITS) -> int:
    return math.ceil(total_bits / limb_bits)


def limb_weights(n_limbs: int, limb_bits: int = PE_BITS) -> list[int]:
    """Positional weights 2^(i*limb_bits) of limb i (little-endian)."""
    return [1 << (i * limb_bits) for i in range(n_limbs)]


def product_limb_pairs(n_limbs: int) -> dict[int, list[tuple[int, int]]]:
    """Every (i, j) limb pair of a full cross-product, grouped by the
    output shift ``i + j``: the anti-diagonals the multi-precision
    accumulator (Fig. 3) sums with shift-adds."""
    groups: dict[int, list[tuple[int, int]]] = {}
    for i in range(n_limbs):
        for j in range(n_limbs):
            groups.setdefault(i + j, []).append((i, j))
    return groups
