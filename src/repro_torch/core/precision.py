"""Precision formats (copy of ``repro.core.precision``, the part serving
needs): the schedule cache keys every GEMM by the GTA precision of its
operands, so the port must map dtypes to the same names as the reference
or the two caches would split.
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
