"""p-GEMM operator record (copy of the part of ``repro.core.pgemm`` the
schedule exploration reads)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.precision import Precision


@dataclasses.dataclass(frozen=True)
class PGEMM:
    """A pseudo-GEMM: C[M,N] (+)= A[M,K] @ B[K,N], ``batch`` independent
    instances, at a given computational precision."""

    name: str
    M: int
    N: int
    K: int
    precision: Precision
    batch: int = 1

    @property
    def macs(self) -> int:
        return self.batch * self.M * self.N * self.K
