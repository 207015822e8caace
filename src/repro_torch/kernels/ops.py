"""The GEMM execution layer: the exact multi-precision ``limb_matmul``,
schedule-driven ``matmul``, ``quant_matmul`` and ``GemmBackend``.

``limb_matmul`` is the paper's §3.1 technique end to end: both operands
cut into balanced int8 limbs, the limb GEMM (K4) summing the limb
products per anti-diagonal, and the multi-precision accumulator
recombining them into (hi, lo) int32 pairs modulo 2^64 -- one launch of
K4's fused entry on the card.

``matmul`` consults a :class:`~repro_torch.core.scheduler.ScheduleCache`
(the paper-§5 exploration, memoized per (M, N, K, precision)), applies the
cached dataflow and fold to the mpgemm kernel, picks the Hopper tiling
for that dataflow (``core.tiling``), and records what executed -- the
effective fold and dataflow -- with ``note_applied``.  Its ``epilogue``
selects K2's fused reduction (the default, and the only one
:class:`GemmBackend` uses) or K6's partial-plane spill baseline.

:class:`GemmBackend` routes model projections (``models.layers.dense``
and the LM head) through ``matmul`` -- and int8 QuantTensor projections
through ``quant_matmul`` (K3) -- when ``ModelConfig.gemm_backend ==
"scheduled"``; ``backend_for(cfg)`` shares one backend, and so one
schedule store, per config.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

from repro_torch.core.dataflow import Dataflow
from repro_torch.core.precision import precision_for_dtype
from repro_torch.core.scheduler import ScheduleCache
from repro_torch.core.tiling import FOLD_GRAIN, HOPPER_BK, BlockConfig, \
    choose_block_config, hopper_tile
from repro_torch.kernels import limb_gemm as _lg
from repro_torch.kernels import mpgemm as _mp
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels.ref import LIMB_BITS, n_limbs_for
from repro_torch.quant.policy import quantize_tensor


def limb_matmul(a: torch.Tensor, b: torch.Tensor, *,
                in_bits: int | None = None,
                blocks: tuple[int, int, int] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact integer GEMM by limb decomposition: (hi, lo) int32 pairs
    holding (a @ b) mod 2^64 in two's complement.

    a (M, K), b (K, N): int8/int16/int32, or int32 holding narrower
    values with ``in_bits`` naming the decomposition width (mixed dtypes
    need it).  Runs where its operands lie: on CUDA tensors one launch of
    K4's fused entry (``limb_gemm.limb_matmul_fused``: digits cut in
    shared memory, the planes folded in registers), on CPU tensors the
    plain composition -- decompose, the limb GEMM's plain version,
    ``combine_diagonals``.  The reference picks blocks with its TPU
    chooser; here ``limb_gemm.limb_plan`` picks the tile unless ``blocks``
    names one of ``limb_gemm.TILES`` as (bm, bn, bk) for the operands'
    digit count -- any other ``blocks`` raises."""
    if a.dtype != b.dtype and in_bits is None:
        raise ValueError("mixed input dtypes need explicit in_bits")
    bits = in_bits or a.element_size() * 8
    nl = n_limbs_for(bits, LIMB_BITS)
    return _lg.limb_matmul_fused(a.contiguous(), b.contiguous(), nl, nl,
                                 blocks=blocks)


def limb_matmul_i32(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """The int32-truncated result (for callers that guarantee no 32-bit
    overflow)."""
    _, lo = limb_matmul(a, b, **kw)
    return lo


@functools.lru_cache(maxsize=4096)
def cached_block_config(M: int, N: int, K: int, ebytes: int, obytes: int,
                        dataflow: Dataflow) -> BlockConfig:
    """Memoized Hopper block choice for one static shape and dataflow."""
    return choose_block_config(M, N, K, dataflow, ebytes=ebytes,
                               obytes=obytes)


def plan_blocks(M: int, N: int, K: int, ebytes: int, dataflow: Dataflow,
                fold_req: int) -> tuple[int, int, int]:
    """(bm, bn, bk) of a launch.  2-byte operands (bf16, the Hopper route):
    the Hopper tile for the output (``tiling.hopper_tile``) and
    ``HOPPER_BK``;
    others (the CUDA-core route): the chooser's tile for this dataflow.
    Either way bk drops to ``FOLD_GRAIN`` when it cannot host the
    requested fold -- the granularity the scheduler's realizable-fold
    filter assumed (the reference's rule, ``kernels/ops.py:180-186``), so
    the fold executes as scheduled."""
    if ebytes == 2:
        (bm, bn), bk = hopper_tile(M, N), HOPPER_BK
    else:
        cfg = cached_block_config(M, N, K, ebytes, 4, dataflow)
        bm, bn, bk = cfg.bm, cfg.bn, cfg.bk
    if fold_req > 1 and _mp.effective_fold(K, bk, fold_req) != fold_req:
        bk = FOLD_GRAIN
    return bm, bn, bk


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           dataflow: Dataflow = Dataflow.OS,
           out_dtype: torch.dtype = torch.float32,
           blocks: tuple[int, int, int] | None = None,
           k_fold: int | None = None,
           schedule: ScheduleCache | None = None,
           epilogue: str = "fused") -> torch.Tensor:
    """GEMM through the mpgemm kernel.

    With ``schedule`` the cached (dataflow, k_fold) of this shape
    overrides ``dataflow`` (SIMD runs the OS pipeline) and the application
    is logged with the fold and dataflow that executed, whatever the
    epilogue.  ``k_fold`` forces a fold; ``blocks`` forces (bm, bn, bk),
    else :func:`plan_blocks` picks them.  ``epilogue="spill"`` runs the
    partial-plane baseline (K6 and a sum; benchmarks only)."""
    M, K = a.shape
    N = b.shape[1]
    fold_req = k_fold
    choice = None
    if schedule is not None:
        prec = precision_for_dtype(a.dtype)
        choice = schedule.resolve(M, N, K, prec)
        dataflow = (Dataflow.OS if choice.dataflow is Dataflow.SIMD
                    else choice.dataflow)
        if fold_req is None:
            fold_req = choice.k_fold
    fold_req = 1 if fold_req is None else fold_req

    if blocks is None:
        bm, bn, bk = plan_blocks(M, N, K, a.element_size(), dataflow,
                                 fold_req)
    else:
        bm, bn, bk = blocks
    ef = _mp.effective_fold(K, bk, fold_req)
    out = _mp.mpgemm(a, b, dataflow=dataflow, bm=bm, bn=bn, bk=bk,
                     k_fold=ef, out_dtype=out_dtype, epilogue=epilogue)
    if schedule is not None:
        # logged after the launch: the applied log lists only GEMMs that
        # really executed
        schedule.note_applied(M, N, K, prec, choice, effective_k_fold=ef,
                              effective_dataflow=dataflow)
    return out


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (K, N) -> (w_q int8 (K, N),
    scale fp32 (N,)), by ``quant.policy.quantize_tensor``."""
    qt = quantize_tensor(w)
    return qt.q, qt.scale


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 *, out_dtype: torch.dtype = torch.float32,
                 schedule: ScheduleCache | None = None) -> torch.Tensor:
    """x (M, K) @ dequant(w_q (K, N), scale (N,)) -> (M, N) through K3.

    With ``schedule`` the shape is resolved under INT8 (GTA's native PE
    width) and, after the launch, the application is logged as it
    executed: K3 is an OS pipeline with the dequant at the accumulator
    flush, so the effective dataflow is OS and the fold 1 whatever the
    modeled winner (the reference's record)."""
    M, K = x.shape
    N = w_q.shape[1]
    choice = None
    if schedule is not None:
        choice = schedule.resolve(M, N, K, "INT8")
    out = _qm.quant_matmul(x.contiguous(), w_q, scale)
    if schedule is not None:
        schedule.note_applied(M, N, K, "INT8", choice, effective_k_fold=1,
                              effective_dataflow=Dataflow.OS)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


class GemmBackend:
    """Routes model projections through the scheduled mpgemm kernels; its
    only state is the :class:`ScheduleCache`."""

    def __init__(self, schedule: ScheduleCache | None = None):
        self.schedule = schedule or ScheduleCache()

    def matmul(self, x2: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(M, K) @ (K, N) through the scheduled kernel."""
        return matmul(x2, w, out_dtype=out_dtype, schedule=self.schedule)

    def head(self, x2: torch.Tensor, w) -> torch.Tensor:
        """Logits of a quantized lm_head (``quant.policy.QuantHead``): x2
        (M, D), already times the head's per-D scale, against the int8
        (D, V) payload through K3 with its unit scale -> fp32 (M, V)."""
        qt = w.q.t()
        if getattr(w, "unit", None) is None or not qt.is_contiguous():
            raise ValueError("a quantized head is built by "
                             "quant.policy.head_operand: its (D, V) "
                             "payload must be contiguous")
        return quant_matmul(x2, qt, w.unit, schedule=self.schedule)

    def dense(self, x: torch.Tensor, w, b: torch.Tensor | None = None
              ) -> torch.Tensor:
        """The scheduled ``layers.dense``: leading dims collapse to one
        (B*S, K) GEMM, the bias is added in fp32, and the result returns
        in x.dtype.  A float weight's product is emitted in the compute
        dtype (mpgemm); a QuantTensor's in fp32, scale applied (K3), so a
        bf16 model rounds once, at the final cast."""
        lead, K = x.shape[:-1], x.shape[-1]
        if hasattr(w, "q") and hasattr(w, "scale"):     # QuantTensor
            out = quant_matmul(x.reshape(-1, K), w.q, w.scale,
                               schedule=self.schedule)
        else:
            out = self.matmul(x.reshape(-1, K), w.to(x.dtype),
                              out_dtype=x.dtype)
        if b is not None:
            out = out.float() + b.float()
        return out.to(x.dtype).reshape(*lead, out.shape[-1])


@functools.lru_cache(maxsize=64)
def _backend_for_key(key) -> GemmBackend:
    return GemmBackend()


#: config -> backend while :func:`private_backends` is active
_PRIVATE: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "private_backends", default=None)


def backend_for(cfg) -> GemmBackend | None:
    """The process-wide backend for a model config, or None when the
    config keeps projections on ``torch.matmul`` (``gemm_backend !=
    "scheduled"``).  Memoized by config equality, so every engine over the
    same model shares one schedule store."""
    if cfg.gemm_backend != "scheduled":
        return None
    shared = _backend_for_key(cfg)
    private = _PRIVATE.get()
    if private is None:
        return shared
    if cfg not in private:
        private[cfg] = GemmBackend(shared.schedule.fork())
    return private[cfg]


@contextlib.contextmanager
def private_backends():
    """Inside, :func:`backend_for` hands out backends of their own whose
    schedule caches start as forks of the shared ones: a pricing run
    (``launch.step_cost``) resolves and logs there, and the shared
    caches' counters and applied logs do not move."""
    token = _PRIVATE.set({})
    try:
        yield
    finally:
        _PRIVATE.reset(token)
