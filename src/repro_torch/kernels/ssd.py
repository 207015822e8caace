"""SSD (Mamba2) intra-chunk kernel (K5): the paper's p-GEMM classification
made concrete for the SSM family.

The chunked SSD algorithm's hot spot is the intra-chunk piece

    y[s] = sum_{t <= s} (C_s . B_t) * exp(cums_s - cums_t) * dt_t * x_t

per (batch, chunk, head): two back-to-back GEMMs, (Q x N) by (N x Q) and
(Q x Q) by (Q x P), with the causal decay mask between them.  B and C
belong to a group of H / G heads, so the score product C . B^T is one per
group.  Two entries wrap ``csrc/ssd_intra.cu`` (the port of the
reference's Pallas ``ssd_intra``), one kernel for both:

  ssd_intra_chunked  the path's call: x (B, nc, Q, H, P), dt and cums
                     (B, nc, Q, H), B and C per group (B, nc, Q, G, N),
                     read in their stored layout; y (B, nc, Q, H, P);
  ssd_intra          the reference's signature: x (G', Q, P), dt and cums
                     (G', Q), b and c (G', Q, N) -- the case batch G', nc =
                     H = G = 1.

On CUDA tensors each launches the kernel or raises; on CPU tensors it
runs its plain version (:func:`ssd_intra_chunked_ref`,
:func:`ssd_intra_ref`).  :func:`ssd_plan` fixes the head block and the
grid from the shapes alone.  Any Q, P, N is taken: the kernel masks its
edges.

Training differentiates ``ssd_intra_chunked`` through
:class:`SsdIntraChunked`, whose backward is K5-bwd
(``csrc/ssd_intra_bwd.cu``, :func:`ssd_intra_chunked_bwd`; the reference
has no Pallas backward: it differentiates its plain jnp SSD).  With M[s,
t] = (C_s . B_t) L[s, t] dt_t and L = exp(cums_s - cums_t) masked causal,
given dY it returns dX = M^T dY, d dt_t = sum_s dM[s, t] (C_s . B_t) L[s,
t] with dM = dY X^T (masked), dC and dB from W = sum over a group's heads
of dM L dt, and dcums = rowsum(dM M) - colsum(dM M).  On CPU tensors the
Function runs the plain forward and :func:`ssd_intra_chunked_bwd_ref`.
Without a graph to build, ``ssd_intra_chunked`` launches K5 directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import _build

#: launches of the CUDA kernel (reset before a run, read after it)
launches = _build.LaunchCounter()
#: launches of K5-bwd (one a backward call: its two kernels together)
bwd_launches = _build.LaunchCounter()

#: s rows a CTA (the kernel's ``kBS``)
S_BLOCK = 64
#: largest heads a CTA, tried from the top (``ssd_plan``)
HEAD_BLOCKS = (16, 8, 4, 2, 1)
#: CTAs an SM holds (two of 8 warps and about 103 KB at Q = 256)
CTAS_PER_SM = 2
#: the kernel's cp.async ring (floats) and a CTA's shared-memory limit
_RING_FLOATS = 9728
MAX_SMEM_BYTES = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {"ssd_intra_launch": ([_P] * 6 + [_STRIDES] + [_I] * 9 + [_P],
                                    _I)}
_BWD_SIGNATURES = {"ssd_intra_bwd_launch": ([_P] * 13 + [_STRIDES]
                                            + [_I] * 8 + [_P], _I)}

#: K5-bwd's tile (s rows of an s-block, t columns of a t-block), largest
#: chunk and head dim (its score and W slabs are Q x 64 fp32 each in
#: shared memory, its dx tile 64 x P in registers)
BWD_BLOCK = 64
BWD_MAX_Q = 256
BWD_MAX_P = 64
#: heads a CTA of K5-bwd's first kernel, tried from the top
BWD_HEAD_BLOCKS = (16, 8, 4, 2, 1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """One launch of K5: ``head_block`` heads of one group a CTA, S_BLOCK
    s rows, and the grid (group x head block, batch x chunk, s-block),
    whose z runs the s-blocks heaviest (last) first."""

    heads_per_group: int
    head_block: int
    s_block: int
    grid: tuple[int, int, int]
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def head_blocks(self) -> int:
        return _ceil(self.heads_per_group, self.head_block)

    def cta(self, x: int, y: int, z: int) -> tuple[int, int, range]:
        """(batch x chunk index, first s row, heads) of CTA (x, y, z): the
        kernel's own mapping."""
        grp, hbi = divmod(x, self.head_blocks)
        h0 = grp * self.heads_per_group + hbi * self.head_block
        h1 = min(h0 + self.head_block, (grp + 1) * self.heads_per_group)
        return y, (self.grid[2] - 1 - z) * self.s_block, range(h0, h1)


def smem_bytes(Q: int) -> int:
    """Dynamic shared memory of a launch: the ring and 64 score rows of
    ceil(Q / 64) * 64 + 4 floats."""
    return 4 * (_RING_FLOATS + S_BLOCK * (_ceil(Q, 64) * 64 + 4))


@functools.lru_cache(maxsize=1024)
def ssd_plan(batch: int, nc: int, Q: int, H: int, G: int) -> SsdPlan:
    """The launch for ``batch`` x ``nc`` chunks of Q rows, H heads in G
    groups, from the shapes alone.

    The head block is the largest of ``HEAD_BLOCKS`` (at most H / G) that
    still gives every SM ``CTAS_PER_SM`` CTAs; the group's heads are then
    dealt into that many blocks of near-equal size.  A larger block
    computes the group's score rows for more heads (the score product
    costs 2 N / (P x block) of the S.X product: 25% at 8 heads of P = 64,
    N = 128), a smaller one fills the card.  At mamba2-2.7b's chunk (8
    chunks, Q 256, 80 heads, G 1) that is 8 heads: 320 CTAs."""
    if min(batch, nc, Q, H, G) <= 0 or H % G:
        raise ValueError(f"degenerate ssd_intra {(batch, nc, Q, H, G)}")
    rep = H // G
    n_s = _ceil(Q, S_BLOCK)
    for hb_max in HEAD_BLOCKS:
        if hb_max > rep:
            continue
        nhb = _ceil(rep, hb_max)
        if batch * nc * G * nhb * n_s >= CTAS_PER_SM * NUM_SMS:
            break
    hb = _ceil(rep, nhb)
    return SsdPlan(rep, hb, S_BLOCK, (G * nhb, batch * nc, n_s),
                   smem_bytes(Q))


def ssd_intra_ref(x: torch.Tensor, dt: torch.Tensor, cums: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``ssd_intra_ref``): fp32 (G, Q, P).

    The decay exponent is masked to -inf above the diagonal before
    ``exp``: for s < t, ``cums_s - cums_t`` is positive and its ``exp``
    overflows within a full-width chunk, so no masked value is ever
    ``inf`` and no product ever meets one."""
    Q = x.shape[1]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cums.float()[:, :, None] - cums.float()[:, None, :]
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    s = torch.bmm(c.float(), b.float().transpose(1, 2)) * L \
        * dt.float()[:, None, :]
    return torch.bmm(s, x.float())


def ssd_intra_chunked_ref(x: torch.Tensor, dt: torch.Tensor,
                          cums: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped entry: fp32 (B, nc, Q, H, P).  The
    scores C . B^T are formed once a group and masked as
    :func:`ssd_intra_ref` masks them (-inf before ``exp``)."""
    Bb, nc, Q, H, P = x.shape
    G = b.shape[3]
    rep = H // G
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    cm = cums.float().permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    seg = cm[..., :, None] - cm[..., None, :]               # (B, nc, H, s, t)
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    sc = torch.einsum("bcsgn,bctgn->bcgst", c.float(), b.float())
    s = sc[:, :, :, None] * L.reshape(Bb, nc, G, rep, Q, Q) \
        * dt.float().permute(0, 1, 3, 2).reshape(Bb, nc, G, rep, 1, Q)
    y = torch.einsum("bcgrst,bctgrp->bcsgrp", s,
                     x.float().reshape(Bb, nc, Q, G, rep, P))
    return y.reshape(Bb, nc, Q, H, P)


def _check_chunked(x, dt, cums, b, c) -> None:
    if x.dim() != 5 or b.dim() != 5 or dt.shape != x.shape[:4] \
            or cums.shape != x.shape[:4] or b.shape[:3] != x.shape[:3] \
            or c.shape != b.shape or b.shape[3] == 0 \
            or x.shape[3] % b.shape[3]:
        raise ValueError(
            f"ssd_intra_chunked needs x (B, nc, Q, H, P), dt and cums (B, "
            f"nc, Q, H), b and c (B, nc, Q, G, N) with G dividing H; got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(cums.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}")
    _check_types(x, dt, cums, b, c)


def _check_types(*ts) -> None:
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_intra takes float32 operands (the caller "
                        "casts, as the reference's ssd_chunked does)")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"ssd_intra operands on several devices: {devs}")


def _aligned(t: torch.Tensor) -> bool:
    """Rows a 16-byte copy can read: a 16-byte-aligned base and every
    outer stride a multiple of 4 elements."""
    return t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:4])


def ssd_intra_chunked(x: torch.Tensor, dt: torch.Tensor, cums: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD contributions in the chunked layout: x (B, nc, Q, H,
    P), dt and cums (B, nc, Q, H), b and c per group (B, nc, Q, G, N),
    head h in group h // (H // G), all fp32 -> y (B, nc, Q, H, P) fp32.
    The CUDA kernel on CUDA tensors (any strides, the innermost dimension
    of x, b and c contiguous), the plain version on CPU tensors.  Where
    autograd records (grad enabled and an operand requiring grad) the
    call goes through :class:`SsdIntraChunked`, whose backward is K5-bwd
    on CUDA tensors."""
    _check_chunked(x, dt, cums, b, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, cums, b, c)):
        return SsdIntraChunked.apply(x, dt, cums, b, c)
    return _ssd_intra_chunked(x, dt, cums, b, c)


def _ssd_intra_chunked(x, dt, cums, b, c) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_intra_chunked_ref(x, dt, cums, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra runs on cuda or cpu, not {x.device}")
    Bb, nc, Q, H, P = x.shape
    G, N = b.shape[3], b.shape[4]
    if min(Bb, nc, Q, H, P, N) == 0:
        raise ValueError(f"degenerate ssd_intra {(Bb, nc, Q, H, P, N)}")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("ssd_intra needs the innermost dimension of x, b "
                         "and c contiguous")
    plan = ssd_plan(Bb, nc, Q, H, G)
    if plan.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_intra: Q = {Q} needs {plan.smem_bytes} bytes "
                         f"of score rows and ring, over a CTA's "
                         f"{MAX_SMEM_BYTES}")
    y = torch.empty((Bb, nc, Q, H, P), dtype=torch.float32, device=x.device)
    vec = P % 4 == 0 and N % 4 == 0 and all(map(_aligned, (x, b, c)))
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (x, dt, cums, b, c, y) for s in t.stride()[:4]))
    lib = _build.load("ssd_intra", _SIGNATURES)
    rc = lib.ssd_intra_launch(
        x.data_ptr(), dt.data_ptr(), cums.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), strides, Bb, nc, Q, H, G, P, N,
        plan.head_block, int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, f"ssd_intra {(Bb, nc, Q, H, G, P, N)}")
    launches.count += 1
    return y


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    """One launch of K5-bwd.  Its first kernel runs a CTA for each (head
    block of one group, batch x chunk, 64-column t-block): ``grid_main``,
    whose z runs the longest walk (the first t-block) first; its second
    sums the head blocks' W and the row sums of dM * M in a fixed order,
    a CTA for each (group, batch x chunk, 64-row block and role dC or
    dB): ``grid_reduce``.  ``wpart_floats`` and ``rowpart_floats`` are
    the fp32 scratch the two kernels share."""

    heads_per_group: int
    head_block: int
    grid_main: tuple[int, int, int]
    grid_reduce: tuple[int, int, int]
    smem_bytes: int
    wpart_floats: int
    rowpart_floats: int

    @property
    def head_blocks(self) -> int:
        return _ceil(self.heads_per_group, self.head_block)


def bwd_smem_bytes(Q: int) -> int:
    """Dynamic shared memory of K5-bwd's first kernel: the score and W
    slabs (Qp x 64 each), four 64 x 68 tiles, cums of the slab's rows,
    cums_t and dt_t, and the column-sum buffer; Qp = Q rounded up to 64
    (the kernel's ``main_smem_floats``)."""
    qp = _ceil(Q, BWD_BLOCK) * BWD_BLOCK
    return 4 * (2 * qp * 64 + 4 * 64 * 68 + qp + 2 * 64 + 2 * 16 * 64)


@functools.lru_cache(maxsize=1024)
def ssd_bwd_plan(batch: int, nc: int, Q: int, H: int, G: int, P: int
                 ) -> SsdBwdPlan:
    """K5-bwd's launch for ``batch`` x ``nc`` chunks of Q rows, H heads of
    head dim P in G groups, from the shapes alone.

    A CTA computes its group's score slab (Q - t0 rows x 64 columns over
    N) once and walks it for each of its heads, so a larger head block
    costs less score work (N / (2 P x block) of the dM and dX products)
    and more W scratch (one Q x Q plane a head block); the block is the
    largest of ``BWD_HEAD_BLOCKS`` (at most H / G) that still gives every
    SM two CTAs (one fits an SM), the group's heads then dealt into that
    many blocks of near-equal size.  At mamba2-2.7b's training call (B 4,
    nc 4, Q 256, H 80, G 1) that is 16 heads: 320 CTAs."""
    if min(batch, nc, Q, H, G, P) <= 0 or H % G:
        raise ValueError(f"degenerate ssd_intra_bwd {(batch, nc, Q, H, G)}")
    if Q > BWD_MAX_Q or P > BWD_MAX_P:
        raise ValueError(f"ssd_intra_bwd takes Q <= {BWD_MAX_Q} and P <= "
                         f"{BWD_MAX_P}; got Q {Q}, P {P}")
    rep = H // G
    ntb = _ceil(Q, BWD_BLOCK)
    for hb_max in BWD_HEAD_BLOCKS:
        if hb_max > rep:
            continue
        nhb = _ceil(rep, hb_max)
        if batch * nc * G * nhb * ntb >= 2 * NUM_SMS:
            break
    hb = _ceil(rep, nhb)
    return SsdBwdPlan(rep, hb, (G * nhb, batch * nc, ntb),
                      (G, batch * nc, 2 * ntb), bwd_smem_bytes(Q),
                      batch * nc * G * nhb * Q * Q,
                      batch * nc * H * ntb * Q)


def ssd_intra_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                              cums: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, dy: torch.Tensor
                              ) -> tuple[torch.Tensor, ...]:
    """Plain version of K5-bwd: the gradient of
    :func:`ssd_intra_chunked_ref` with respect to (x, dt, cums, b, c),
    given dy (B, nc, Q, H, P), written out from the forward's formula in
    fp32, the decay exponent masked to -inf before ``exp`` as the forward
    masks it."""
    Bb, nc, Q, H, P = x.shape
    G = b.shape[3]
    rep = H // G
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    cm = cums.float().permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    L = torch.exp((cm[..., :, None] - cm[..., None, :]).masked_fill(
        ~causal, float("-inf")))                            # (B, nc, H, s, t)
    R = torch.einsum("bcsgn,bctgn->bcgst", c.float(), b.float())
    RL = (R[:, :, :, None] * L.reshape(Bb, nc, G, rep, Q, Q)).reshape(
        Bb, nc, H, Q, Q)
    dth = dt.float().permute(0, 1, 3, 2)[..., None, :]      # (B, nc, H, 1, t)
    M = RL * dth
    xh = x.float().permute(0, 1, 3, 2, 4)                   # (B, nc, H, t, P)
    dyh = dy.float().permute(0, 1, 3, 2, 4)                 # (B, nc, H, s, P)
    dM = torch.einsum("bchsp,bchtp->bchst", dyh, xh).masked_fill(~causal, 0.0)
    dx = torch.einsum("bchst,bchsp->bcthp", M, dyh)
    ddt = (dM * RL).sum(dim=-2).permute(0, 1, 3, 2)         # over s
    W = (dM * L * dth).reshape(Bb, nc, G, rep, Q, Q).sum(dim=3)
    dc = torch.einsum("bcgst,bctgn->bcsgn", W, b.float())
    db = torch.einsum("bcgst,bcsgn->bctgn", W, c.float())
    Z = dM * M
    dcums = (Z.sum(dim=-1) - Z.sum(dim=-2)).permute(0, 1, 3, 2)
    return dx, ddt, dcums, db, dc


def ssd_intra_chunked_bwd(x: torch.Tensor, dt: torch.Tensor,
                          cums: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor, dy: torch.Tensor
                          ) -> tuple[torch.Tensor, ...]:
    """(dx, d dt, d cums, db, dc) of :func:`ssd_intra_chunked` given dy,
    fp32, each contiguous in its operand's shape: K5-bwd on CUDA tensors
    (any strides; Q <= 256, P <= 64), the plain version on CPU tensors."""
    _check_chunked(x, dt, cums, b, c)
    if dy.shape != x.shape or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"ssd_intra_chunked_bwd needs dy like x "
                         f"{tuple(x.shape)} fp32 on {x.device}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if x.device.type == "cpu":
        return ssd_intra_chunked_bwd_ref(x, dt, cums, b, c, dy)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_bwd runs on cuda or cpu, not {x.device}")
    Bb, nc, Q, H, P = x.shape
    G, N = b.shape[3], b.shape[4]
    if min(Bb, nc, Q, H, P, N) == 0:
        raise ValueError(f"degenerate ssd_intra_bwd {(Bb, nc, Q, H, P, N)}")
    plan = ssd_bwd_plan(Bb, nc, Q, H, G, P)
    if plan.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_intra_bwd: Q = {Q} needs {plan.smem_bytes} "
                         f"bytes of shared memory, over a CTA's "
                         f"{MAX_SMEM_BYTES}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, nc, Q, H, P), **f32)
    ddt = torch.empty((Bb, nc, Q, H), **f32)
    dcums = torch.empty((Bb, nc, Q, H), **f32)
    db = torch.empty((Bb, nc, Q, G, N), **f32)
    dc = torch.empty((Bb, nc, Q, G, N), **f32)
    wpart = torch.empty(plan.wpart_floats, **f32)
    rowpart = torch.empty(plan.rowpart_floats, **f32)
    strides = (ctypes.c_longlong * 28)(
        *x.stride(), *dt.stride(), *cums.stride(), *b.stride(), *c.stride(),
        *dy.stride())
    lib = _build.load("ssd_intra_bwd", _BWD_SIGNATURES)
    rc = lib.ssd_intra_bwd_launch(
        x.data_ptr(), dt.data_ptr(), cums.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dcums.data_ptr(), db.data_ptr(), dc.data_ptr(), wpart.data_ptr(),
        rowpart.data_ptr(), strides, Bb, nc, Q, H, G, P, N,
        plan.head_block, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, f"ssd_intra_bwd {(Bb, nc, Q, H, G, P, N)}")
    bwd_launches.count += 1
    return dx, ddt, dcums, db, dc


class SsdIntraChunked(torch.autograd.Function):
    """``ssd_intra_chunked`` under autograd: forward K5 (CUDA tensors) or
    :func:`ssd_intra_chunked_ref` (CPU tensors), backward K5-bwd or
    :func:`ssd_intra_chunked_bwd_ref` likewise.  The operands are saved,
    not the output: the caller may add into y in place."""

    @staticmethod
    def forward(ctx, x, dt, cums, b, c):
        ctx.save_for_backward(x, dt, cums, b, c)
        return _ssd_intra_chunked(x, dt, cums, b, c)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_chunked_bwd(*ctx.saved_tensors, dy.float())


def _check(x, dt, cums, b, c) -> None:
    if x.dim() != 3 or b.dim() != 3 or c.dim() != 3 \
            or dt.shape != x.shape[:2] or cums.shape != x.shape[:2] \
            or b.shape[:2] != x.shape[:2] or c.shape != b.shape:
        raise ValueError(f"ssd_intra needs x (G, Q, P), dt and cums (G, Q), "
                         f"b and c (G, Q, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(cums.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    _check_types(x, dt, cums, b, c)


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, cums: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD contributions: x (G, Q, P), dt and cums (G, Q), b
    and c (G, Q, N), all fp32 -> y (G, Q, P) fp32; the CUDA kernel on
    CUDA tensors (through :func:`ssd_intra_chunked` with each g a batch
    row of one head), the plain version on CPU tensors."""
    _check(x, dt, cums, b, c)
    if x.device.type == "cpu":
        return ssd_intra_ref(x, dt, cums, b, c)
    y = ssd_intra_chunked(*(t[:, None, :, None] for t in (x, dt, cums, b, c)))
    return y[:, 0, :, 0]
