"""Paged-decode attention (K1): gather K/V through a block table.

The paged KV pool (``serving.kv_pool``) stores each attention layer's K/V
as ``(num_blocks, block_size, KV, hd)``; a slot's logical sequence is the
concatenation of the pool blocks named by its block-table row.  Decode
attention over that layout is a chain of two skinny p-GEMMs per block --
scores (G, block_size, hd) and the weighted values (G, hd, block_size) --
stitched by an online softmax.

Two implementations, one contract:

  * :func:`paged_decode` -- the wrapper of the CUDA kernel
    ``csrc/paged_decode.cu`` (the port of the reference's Pallas
    ``paged_decode_kernel``).  On a CUDA tensor it launches the kernel or
    raises; on CPU tensors it runs the plain version.
  * :func:`gather_fallback` -- the plain PyTorch version: gather each
    row's blocks into a contiguous view and run one masked softmax.  It is
    the kernel's oracle and the CPU path.

The kernel splits each row's blocks over a grid that :func:`split_plan`
fixes from the shapes alone, and combines the splits' partial softmax
states in a fixed order; :func:`split_decode_plain` repeats that
arithmetic in plain PyTorch for the tests.

Int8 pools (the quantized KV of ``cfg.quant_kv``) come with fp32
``k_scale``/``v_scale`` sidecars (num_blocks, block_size, KV), one scale
per written position and KV head; both implementations dequantize in
fp32, ``float(int8) * scale``, as the reference's Pallas kernel does (its
gather fallback dequantizes through q.dtype instead, which differs in
bf16).  The int8 variant (K1-int8) counts its launches apart from the fp
one.

A row of length 0 attends over nothing and yields zeros in both (the
reference's Pallas kernel does the same; its gather fallback returns the
mean of the gathered V instead, see ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of the CUDA kernel with fp pools, K1 (reset before a run)
launches = _build.LaunchCounter()
#: launches of the CUDA kernel with int8 pools, K1-int8
launches_int8 = _build.LaunchCounter()

_TAIL = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_void_p] + [ctypes.c_int] * 11
         + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {
    "paged_decode_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 3 + _TAIL,
                            ctypes.c_int),
    "paged_decode_int8_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                 + _TAIL, ctypes.c_int)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a CTA may hold on an H100, with the opt-in (bytes)
_SMEM_MAX = 227 * 1024
#: ring stages of the staged K/V blocks, the most that fit first: with 5
#: the prologue stages a split of up to 4 blocks whole
_STAGES = (5, 4, 3)
#: the kernel's query rows a CTA holds: 4 warps x 2 row pairs
MAX_GROUP = 16
#: the kernel's widest head: a lane holds up to 4 pairs of V dims
MAX_HEAD_DIM = 256
#: streaming multiprocessors of an H100 SXM; split_plan aims at two CTAs
#: on each
SMS = 132
#: blocks the kernel folds in one softmax update (``kUnits``)
FOLD_UNITS = 4
#: fewest positions a split holds, so that its partial (G * hdv + 2G
#: floats) stays small beside the K/V it reads
MIN_SPLIT_POSITIONS = 32


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def gather_pool_blocks(buf: torch.Tensor, block_table: torch.Tensor
                       ) -> torch.Tensor:
    """Pool (num_blocks, block_size, ...) + table (B, nbs) -> contiguous
    per-row KV (B, nbs * block_size, ...).  Every paged read path goes
    through here so paged index semantics live in one place."""
    B, nbs = block_table.shape
    out = buf.index_select(0, block_table.reshape(-1).long())
    return out.reshape((B, nbs * buf.shape[1]) + tuple(buf.shape[2:]))


def gather_fallback(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float,
                    window: int | None = None,
                    logit_cap: float | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: q (B, KV, G, hd); pools (nb, bs, KV,
    hd), int8 with ``k_scale``/``v_scale`` (nb, bs, KV); block_table
    (B, nbs) int32; lengths (B,) int32 -> (B, KV, G, hd) in q.dtype,
    computed (and dequantized) in fp32."""
    nbs, bs = block_table.shape[1], k_pool.shape[1]
    k = gather_pool_blocks(k_pool, block_table).float()
    v = gather_pool_blocks(v_pool, block_table).float()
    if k_scale is not None:
        k = k * gather_pool_blocks(k_scale, block_table).float()[..., None]
        v = v * gather_pool_blocks(v_scale, block_table).float()[..., None]
    s = torch.einsum("bkgd,btkd->bkgt", q.float() * scale, k)
    s = _softcap(s, logit_cap)
    kvpos = torch.arange(nbs * bs, device=q.device)
    ln = lengths.long()[:, None, None, None]
    mask = kvpos < ln
    if window is not None:
        mask &= (ln - 1) - kvpos < window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1) * mask
    return torch.einsum("bkgt,btkd->bkgd", p, v).to(q.dtype)


def _check(q, k_pool, v_pool, block_table, lengths, k_scale=None,
           v_scale=None) -> None:
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (B, KV, G, hd) and the pools "
                         "(num_blocks, block_size, KV, hd)")
    B, KV, G, hd = q.shape
    if k_pool.shape[2:] != (KV, hd) or v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    quant = k_pool.dtype == torch.int8
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged decode takes float32 or bfloat16 q with "
                        f"pools of the same type or int8 pools, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise TypeError("int8 pools need k_scale and v_scale, and scales "
                        "go only with int8 pools")
    if quant:
        for sc in (k_scale, v_scale):
            if sc.shape != k_pool.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f"scales must be float32 "
                                 f"{tuple(k_pool.shape[:3])}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError("block_table must be (B, nbs) and lengths (B,)")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    devs = {t.device for t in (q, k_pool, v_pool, block_table, lengths,
                               k_scale, v_scale) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"paged decode operands on several devices: {devs}")


def split_plan(B: int, KV: int, nbs: int, bs: int) -> tuple[int, int]:
    """(blocks_per_split, n_splits) of the kernel's split-KV grid (n_splits,
    KV, B) for B rows of ``nbs`` table entries of ``bs`` positions.

    Shapes alone decide it, never the lengths or the table, so a call
    reads no device value: about two CTAs per SM, each split at least
    ``MIN_SPLIT_POSITIONS`` positions, and no empty trailing split
    (``(n_splits - 1) * blocks_per_split < nbs``)."""
    want = -(-2 * SMS // max(B * KV, 1))
    bps = max(-(-nbs // want), -(-MIN_SPLIT_POSITIONS // bs), 1)
    bps = min(bps, max(nbs, 1))
    return bps, -(-max(nbs, 1) // bps)


def _smem_bytes(G: int, bs: int, hd: int, hdv: int, elem: int, quant: bool,
                stages: int) -> int:
    """Shared memory of the split kernel (``front_bytes`` + stages x
    ``stage_bytes`` in ``paged_decode.cu``): q in fp32, the warps'
    probabilities and 128 table entries, then a ring of K tiles (rows
    padded to an odd number of 16-byte chunks), V tiles and, for int8
    pools, 2 x bs fp32 scales."""
    def a16(n):
        return -(-n // 16) * 16
    ck = a16(hd * elem) // 16
    front = 4 * (G * ck * (16 // elem) + 4 * 32 * 4 + 128)
    stage = bs * (16 * (ck + 1 + (ck & 1)) + a16(hdv * elem)) \
        + (a16(8 * bs) if quant else 0)
    return front + stages * stage


def _copy_width(k_pool: torch.Tensor, v_pool: torch.Tensor) -> int:
    """16 when a K row, a V row and both pool addresses are 16-byte
    aligned (the kernel stages with 16-byte ``cp.async``), else 1 (byte
    copies)."""
    elem = k_pool.element_size()
    sizes = (k_pool.shape[3] * elem, v_pool.shape[3] * elem,
             k_pool.data_ptr(), v_pool.data_ptr())
    return 16 if all(n % 16 == 0 for n in sizes) else 1


def split_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       blocks_per_split: int, window: int | None = None,
                       logit_cap: float | None = None,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for tests: each split of
    ``blocks_per_split`` blocks folds its live blocks into (m, l, acc) in
    fp32 -- all in one softmax update when there are at most
    ``FOLD_UNITS`` of them, as the kernel's main path does, else one
    block at a time -- then the live splits are combined in order s = 0,
    1, ...  Same contract as :func:`gather_fallback`; nothing on the
    serving path calls it."""
    B, KV, G, _ = q.shape
    bs, hdv, nbs = k_pool.shape[1], v_pool.shape[3], block_table.shape[1]
    qs = q.float() * scale
    out = torch.zeros((B, KV, G, hdv), dtype=torch.float32)
    for b in range(B):
        ln = int(lengths[b])
        hi = min(ln, nbs * bs)
        lo = 0 if window is None else max(0, ln - max(int(window), 0))
        if lo >= hi:
            continue                        # no live split: zeros
        blk_lo, blk_hi = lo // bs, -(-hi // bs)
        parts = []
        for s in range(blk_lo // blocks_per_split,
                       -(-blk_hi // blocks_per_split)):
            m = torch.full((KV, G), NEG_INF)
            l = torch.zeros((KV, G))
            acc = torch.zeros((KV, G, hdv))
            live = list(range(max(blk_lo, s * blocks_per_split),
                              min(blk_hi, (s + 1) * blocks_per_split)))
            passes = [live] if len(live) <= FOLD_UNITS else [[j] for j in live]
            for js in passes:
                blks = block_table[b, js].long()
                k = k_pool[blks].float().flatten(0, 1)
                v = v_pool[blks].float().flatten(0, 1)
                if k_scale is not None:
                    k = k * k_scale[blks].float().flatten(0, 1)[..., None]
                    v = v * v_scale[blks].float().flatten(0, 1)[..., None]
                sc = _softcap(torch.einsum("kgd,tkd->kgt", qs[b], k),
                              logit_cap)
                pos = (torch.tensor(js)[:, None] * bs
                       + torch.arange(bs)).flatten()
                valid = (pos >= lo) & (pos < hi)
                sc = torch.where(valid, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] \
                    + torch.einsum("kgt,tkd->kgd", p, v)
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = sum(l * torch.exp(m - M) for m, l, _ in parts)
        num = sum(acc * torch.exp(m - M)[..., None] for m, _, acc in parts)
        out[b] = num / torch.clamp(L, min=1e-30)[..., None]
    return out.to(q.dtype)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float, window: int | None = None,
                 logit_cap: float | None = None,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged-decode attention: the CUDA kernel on a CUDA tensor (K1, or
    K1-int8 for int8 pools with scales), the plain version on CPU
    tensors.  Same contract as :func:`gather_fallback`.  The kernel's
    split-KV grid comes from :func:`split_plan` (shapes only), so the
    call reads no device value."""
    _check(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return gather_fallback(q, k_pool, v_pool, block_table, lengths,
                               scale=scale, window=window,
                               logit_cap=logit_cap, k_scale=k_scale,
                               v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    quant = k_scale is not None
    tensors = (q, k_pool, v_pool, block_table, lengths) \
        + ((k_scale, v_scale) if quant else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode needs contiguous operands")
    B, KV, G, hd = q.shape
    bs, hdv, nbs = k_pool.shape[1], v_pool.shape[3], block_table.shape[1]
    if G > MAX_GROUP or max(hd, hdv) > MAX_HEAD_DIM:
        raise ValueError(f"paged decode takes G <= {MAX_GROUP} query rows "
                         f"a KV head and head dims <= {MAX_HEAD_DIM}, got "
                         f"G={G}, hd={hd}, hdv={hdv}")
    smem = functools.partial(_smem_bytes, G, bs, hd, hdv,
                             k_pool.element_size(), quant)
    stages = next((n for n in _STAGES if smem(n) <= _SMEM_MAX), None)
    if stages is None:
        raise ValueError(f"paged decode needs {smem(_STAGES[-1])} B of "
                         f"shared memory (> {_SMEM_MAX})")
    out = torch.empty((B, KV, G, hdv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    bps, n_splits = split_plan(B, KV, nbs, bs)
    part = None if n_splits == 1 else torch.empty(
        (B, KV, n_splits, G, hdv + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("paged_decode", _SIGNATURES)
    tail = (block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), B, KV, G, hd, hdv, bs,
            nbs, bps, n_splits, _copy_width(k_pool, v_pool), stages,
            float(scale), -1 if window is None else max(int(window), 0),
            0.0 if logit_cap is None else float(logit_cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        rc = lib.paged_decode_int8_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        _build.check_launch(rc, "paged_decode_int8")
        launches_int8.count += 1
    else:
        rc = lib.paged_decode_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), *tail)
        _build.check_launch(rc, "paged_decode")
        launches.count += 1
    return out


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     window: int | None = None,
                     logit_cap: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """Public paged-decode entry point: runs on ``device`` (CUDA unless the
    caller names another) and raises if the operands lie elsewhere."""
    dev = resolve_device(device)
    if q.device.type != dev.type:
        raise ValueError(f"operands on {q.device}, expected {dev}")
    return paged_decode(q, k_pool, v_pool, block_table, lengths, scale=scale,
                        window=window, logit_cap=logit_cap, k_scale=k_scale,
                        v_scale=v_scale)


# ---------------------------------------------------------------------------
# Schedule-space registration (paper §5 over the gather-GEMM shapes)
# ---------------------------------------------------------------------------

def gather_gemm_shapes(cfg, block_size: int) -> list[tuple[int, int, int]]:
    """The two per-block p-GEMMs of the paged-decode chain, per KV head:
    scores (G, block_size, hd) and weighted values (G, hd, block_size).
    MLA decodes in latent space (the absorbed path), so its two contract
    over kv_lora_rank + rope dim: (H, block_size, r + rp) and (H, r,
    block_size)."""
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return [(cfg.n_heads, block_size, r),
                (cfg.n_heads, cfg.mla.kv_lora_rank, block_size)]
    G = cfg.n_heads // cfg.n_kv_heads
    return [(G, block_size, cfg.hd), (G, cfg.hd, block_size)]


def resolve_gather_gemms(schedule, cfg, block_size: int, precision: str
                         ) -> list:
    """Resolve the gather GEMMs through the schedule cache (does not mark
    them applied; see :func:`note_gather_applied`)."""
    return [(M, N, K, schedule.resolve(M, N, K, precision))
            for M, N, K in gather_gemm_shapes(cfg, block_size)]


def note_gather_applied(schedule, cfg, block_size: int,
                        precision: str) -> None:
    """Record one paged-decode application of the gather-GEMM shapes,
    called by the engine right after each decode step that ran them."""
    for M, N, K, choice in resolve_gather_gemms(schedule, cfg, block_size,
                                                precision):
        schedule.note_applied(M, N, K, precision, choice)
