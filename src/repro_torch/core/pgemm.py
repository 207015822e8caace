"""p-GEMM operator IR and classification (copy of ``repro.core.pgemm``,
paper §3.2).

Operators with data reuse are rewritten into GEMM form -- "p-GEMM", GEMMs
of any (possibly degenerate) size: matmul, matvec, inner product,
im2col'd convolution, MTTKRP -- and go to the systolic path; reuse-free
operators are vector work.  ``PGEMM`` / ``VectorOp`` lists are what the
workloads (``core.workloads``) and the simulators (``core.simulator``)
consume, and ``PGEMM`` is what the schedule exploration costs.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from collections.abc import Sequence

from repro_torch.core.precision import Precision


class ExecPath(enum.Enum):
    GEMM = "gemm"      # systolic path
    VECTOR = "vector"  # vector / elementwise path


@dataclasses.dataclass(frozen=True)
class PGEMM:
    """A pseudo-GEMM: C[M,N] (+)= A[M,K] @ B[K,N], ``batch`` independent
    instances, at a given computational precision (M=1 a GEMV, N=1 a
    matvec, M=N=1 an inner product)."""

    name: str
    M: int
    N: int
    K: int
    precision: Precision
    batch: int = 1

    @property
    def macs(self) -> int:
        return self.batch * self.M * self.N * self.K

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def min_bytes(self) -> int:
        """Compulsory traffic: each operand and the result touched once."""
        b = self.precision.bytes
        return self.batch * b * (self.M * self.K + self.K * self.N
                                 + self.M * self.N)

    @property
    def arithmetic_intensity(self) -> float:
        """MACs per byte of compulsory traffic (the paper's reuse axis)."""
        return self.macs / self.min_bytes

    @property
    def parallelism(self) -> int:
        """Independent MACs a K-step (the paper's parallelism axis)."""
        return self.batch * self.M * self.N

    def scaled(self, name: str | None = None, **dims) -> PGEMM:
        return dataclasses.replace(self, name=name or self.name, **dims)


@dataclasses.dataclass(frozen=True)
class VectorOp:
    """A reuse-free vector operator: ``n_elems`` elements of
    ``ops_per_elem`` primitive operations each, at a precision."""

    name: str
    n_elems: int
    precision: Precision
    ops_per_elem: int = 1

    @property
    def flops(self) -> int:
        return self.n_elems * self.ops_per_elem

    @property
    def min_bytes(self) -> int:
        # two operand streams + one result stream
        return 3 * self.n_elems * self.precision.bytes

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.min_bytes

    @property
    def parallelism(self) -> int:
        return self.n_elems


Operator = PGEMM | VectorOp


#: Reuse (MACs per element touched) below which an op is inner-product
#: like: no operand is used twice (Fig. 2's zero-intensity band) ...
GEMM_REUSE_THRESHOLD = 1.0
#: ... unless enough independent outputs exist to reuse the shared
#: operand spatially (a GEMV reuses x M times).
VECTOR_PARALLELISM_CAP = 8


def classify(op: Operator) -> ExecPath:
    """Route an operator to the GEMM (systolic) or the vector path."""
    if isinstance(op, VectorOp):
        return ExecPath.VECTOR
    elements = (op.M * op.K + op.K * op.N + op.M * op.N) * op.batch
    reuse = op.macs / max(1, elements)
    if reuse < GEMM_REUSE_THRESHOLD and \
            op.parallelism <= VECTOR_PARALLELISM_CAP:
        return ExecPath.VECTOR
    return ExecPath.GEMM


# ---------------------------------------------------------------------------
# Operator -> p-GEMM rewrites (§3.2)
# ---------------------------------------------------------------------------

def conv2d_as_pgemm(name: str, *, batch: int, in_ch: int, out_ch: int,
                    img_hw: tuple[int, int], kernel_hw: tuple[int, int],
                    stride: int = 1, pad: int = 0,
                    precision: Precision) -> PGEMM:
    """im2col: CONV(B,H,W,Cin->Cout,KhKw) == GEMM(M=B*Ho*Wo, N=Cout,
    K=Cin*Kh*Kw)."""
    h, w = img_hw
    kh, kw = kernel_hw
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    return PGEMM(name, M=batch * ho * wo, N=out_ch, K=in_ch * kh * kw,
                 precision=precision)


def linear_as_pgemm(name: str, *, batch_tokens: int, d_in: int, d_out: int,
                    precision: Precision) -> PGEMM:
    return PGEMM(name, M=batch_tokens, N=d_out, K=d_in, precision=precision)


def mttkrp_as_pgemm(name: str, *, i: int, j: int, k: int, r: int,
                    precision: Precision) -> PGEMM:
    """MTTKRP A(i,r) = sum_{j,k} T(i,j,k) B(j,r) C(k,r): after the
    Khatri-Rao product, GEMM(M=i, N=r, K=j*k)."""
    return PGEMM(name, M=i, N=r, K=j * k, precision=precision)


def bignum_mult_as_pgemm(name: str, *, digits_bits: int, n_mults: int,
                         precision: Precision) -> PGEMM:
    """Schoolbook big-number multiplication: result limb k is
    sum_{i+j=k} x_i y_j, a sliding-window p-GEMM with M = 2n-1 output
    limbs, K = n, N = 1 (§3.1)."""
    n_limbs = math.ceil(digits_bits / precision.mult_bits)
    return PGEMM(name, M=2 * n_limbs - 1, N=1, K=n_limbs,
                 precision=precision, batch=n_mults)


def attention_scores_as_pgemm(name: str, *, q_tokens: int, kv_tokens: int,
                              d_head: int, heads: int,
                              precision: Precision) -> PGEMM:
    return PGEMM(name, M=q_tokens, N=kv_tokens, K=d_head,
                 precision=precision, batch=heads)


def total_flops(ops: Sequence[Operator]) -> int:
    return sum(op.flops for op in ops)


def split_paths(ops: Sequence[Operator]
                ) -> tuple[list[PGEMM], list[VectorOp]]:
    """Partition a workload's operators by execution path; a degenerate
    p-GEMM on the vector path becomes a VectorOp of 2 ops a MAC."""
    gemms: list[PGEMM] = []
    vecs: list[VectorOp] = []
    for op in ops:
        if classify(op) is ExecPath.GEMM:
            gemms.append(op)
        elif isinstance(op, PGEMM):
            vecs.append(VectorOp(op.name, op.macs, op.precision, 2))
        else:
            vecs.append(op)
    return gemms, vecs
