"""GQA attention (port of ``repro.models.attention``, MLA aside): the
full sequence, dense KV stripes, and the block-paged KV pool.

Shapes: x (B, S, D); q (B, S, H, hd).  Three layouts of the KV:

  * none (``cache=None``): the full-sequence forward attends over its own
    k/v;
  * dense stripes (``block_table=None``): k/v (B, max_len, KV, hd) with a
    write position ``pos``, a scalar (the wave engine) or (B,) (the dense
    continuous engine's slots); ``_cache_write`` writes at ``pos``
    clamped to ``max_len - S``, as ``jax.lax.dynamic_update_slice``
    clamps, so a slot at ``max_len`` writes onto its last row;
  * pools (num_blocks, block_size, KV, hd) addressed through a per-slot
    block table (B, nbs); ``pos`` per-slot write cursors (B,).  Decode
    steps (S == 1) run the paged-decode kernel
    (``kernels.paged_attention``); prefill chunks (S > 1) gather the
    slot's blocks.

Everything but the paged decode step runs the blockwise online-softmax
``_flash`` in plain PyTorch (the reference's is plain JAX as well); on
dense stripes it walks the whole stripe with ``kv_valid = pos + S``.

The KV pools and stripes are updated IN PLACE: ``_paged_write`` and
``_cache_write`` write into the tensor they are given and return it.
Under ``cfg.quant_kv`` the pools are int8 with fp32 per-(position, KV
head) scale sidecars ``k_scale`` / ``v_scale``: ``_paged_write_quant``
quantizes each written row on the way in, decode runs the int8 kernel
variant, and the prefill gather dequantizes through the compute dtype
(the reference's rounding).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.models.config import BlockKind, ModelConfig, RopeMode
from repro_torch.models.layers import ParamDef, apply_rope, dense, \
    rope_tables, softcap

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    defs = {"wq": ParamDef((d, H * hd)), "wk": ParamDef((d, KV * hd)),
            "wv": ParamDef((d, KV * hd)), "wo": ParamDef((H * hd, d))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), init="zeros")
        defs["bk"] = ParamDef((KV * hd,), init="zeros")
        defs["bv"] = ParamDef((KV * hd,), init="zeros")
    return defs


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, window: int | None,
           q_offset: torch.Tensor | int, kv_valid: torch.Tensor | None,
           logit_cap: float | None, block: int) -> torch.Tensor:
    """q (B, Sq, KV, G, hd); k/v (B, T, KV, hd) -> (B, Sq, KV, G, hd).

    Walks the KV blocks with the online-softmax (m, l, acc) carry and
    masks causality, the window and per-row validity by absolute
    positions; ``q_offset``/``kv_valid`` are scalars or (B,) tensors."""
    B, Sq, KV, G, hd = q.shape
    hd_v = v.shape[-1]
    T = k.shape[1]
    dev = q.device
    block = min(block, T)
    if T % block:  # pad kv to a block multiple; padded keys are masked
        pad = block - T % block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid is None:
            kv_valid = torch.tensor(T, dtype=torch.int32, device=dev)
        T = k.shape[1]
    qpos = (torch.atleast_1d(torch.as_tensor(q_offset, device=dev)).long()
            [:, None] + torch.arange(Sq, device=dev)[None, :])
    kv_bound = (None if kv_valid is None else
                torch.atleast_1d(torch.as_tensor(kv_valid, device=dev))
                .long()[:, None, None])
    qf = q.float() * scale
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd_v), dtype=torch.float32, device=dev)
    for j in range(T // block):
        kj = k[:, j * block:(j + 1) * block].float()
        vj = v[:, j * block:(j + 1) * block].float()
        kvpos = j * block + torch.arange(block, device=dev)
        s = softcap(torch.einsum("bskgd,btkd->bkgst", qf, kj), logit_cap)
        mask = torch.ones((1, Sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kvpos[None, None, :] <= qpos[:, :, None])
        if window is not None:
            mask = mask & (qpos[:, :, None] - kvpos[None, None, :] < window)
        if kv_bound is not None:
            mask = mask & (kvpos[None, None, :] < kv_bound)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def paged_flat_index(block_table: torch.Tensor, pos: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Per-row logical positions (B, S) -> flat pool indices (B, S).
    Positions outside the table resolve to the NULL block 0, so stray
    writes of rows riding along in a batched step land in the trash
    block, never in a neighbour's data."""
    nbs = block_table.shape[1]
    blk = torch.div(pos, block_size, rounding_mode="floor")
    oob = (blk < 0) | (blk >= nbs)
    bid = torch.gather(block_table.long(), 1, blk.clamp(0, nbs - 1))
    bid = torch.where(oob, 0, bid)
    return bid * block_size + torch.remainder(pos, block_size)


def _paged_write(buf: torch.Tensor, update: torch.Tensor, pos: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """Scatter ``update`` (B, S, ...) into the pool ``buf`` (num_blocks,
    block_size, ...) IN PLACE at logical positions pos .. pos + S."""
    nb, bs = buf.shape[0], buf.shape[1]
    B, S = update.shape[0], update.shape[1]
    pos_rows = (pos.long().reshape(-1, 1)
                + torch.arange(S, device=buf.device)[None, :])
    idx = paged_flat_index(block_table, pos_rows, bs).reshape(-1)
    flat = buf.view((nb * bs,) + tuple(buf.shape[2:]))
    flat.index_copy_(0, idx, update.to(buf.dtype).reshape(
        (B * S,) + tuple(update.shape[2:])))
    return buf


def _cache_write(buf: torch.Tensor, update: torch.Tensor,
                 pos: torch.Tensor | int) -> torch.Tensor:
    """Write ``update`` (B, S, ...) into the stripes ``buf`` (B, T, ...)
    IN PLACE at time index ``pos``: a scalar (every row) or (B,) (each
    row its own).  The start is clamped to [0, T - S], as
    ``jax.lax.dynamic_update_slice`` clamps it: no index error and no
    wrap.  Index tensors only, so no device value is read."""
    B, T = buf.shape[0], buf.shape[1]
    S = update.shape[1]
    dev = buf.device
    upd = update.to(buf.dtype)
    start = torch.as_tensor(pos, device=dev).long().clamp(0, T - S)
    if start.dim() == 0:
        return buf.index_copy_(1, start + torch.arange(S, device=dev), upd)
    rows = (torch.arange(B, device=dev)[:, None] * T + start[:, None]
            + torch.arange(S, device=dev)[None, :])
    tail = tuple(buf.shape[2:])
    buf.view((B * T,) + tail).index_copy_(0, rows.reshape(-1),
                                          upd.reshape((B * S,) + tail))
    return buf


def _paged_write_quant(qbuf: torch.Tensor, sbuf: torch.Tensor,
                       update: torch.Tensor, pos: torch.Tensor,
                       block_table: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-write into an int8 pool and its scale sidecar, IN
    PLACE: ``update`` (B, S, KV, hd) is quantized symmetrically along hd,
    one fp32 scale per written token and KV head (amax / 127; an all-zero
    row -- padding, writes into the NULL block -- gets 1.0, so it
    dequantizes to exact zeros).  Bit-identical to the reference."""
    upf = update.float()
    amax = upf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(upf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return (_paged_write(qbuf, q, pos, block_table),
            _paged_write(sbuf, scale, pos, block_table))


def gqa_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  kind: BlockKind, pos_offset: torch.Tensor | int = 0,
                  cache: dict | None = None,
                  block_table: torch.Tensor | None = None,
                  pos_advance: torch.Tensor | None = None,
                  backend=None) -> tuple[torch.Tensor, dict | None]:
    """GQA attention over the full sequence (``cache=None``), dense
    stripes (a cache and no ``block_table``) or the paged pool (both):
    writes k/v at each row's cursor and attends over the row's valid
    prefix.  ``pos_advance`` (B,) overrides the paged cursor increment
    (ragged chunks advance by each row's real token count).  ``kind``
    ATTN_LOCAL attends over the last ``cfg.local_window`` positions only
    (query position minus key position below the window, in the decode
    kernel and in ``_flash`` alike).  Returns (out, new cache with
    advanced cursors, or None)."""
    if kind not in (BlockKind.ATTN, BlockKind.ATTN_LOCAL):
        raise NotImplementedError(f"{kind} blocks are not ported yet")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV

    q = dense(x, p["wq"], p.get("bq"), backend=backend).view(B, S, H, hd)
    k = dense(x, p["wk"], p.get("bk"), backend=backend).view(B, S, KV, hd)
    v = dense(x, p["wv"], p.get("bv"), backend=backend).view(B, S, KV, hd)

    if cfg.rope_mode is not RopeMode.NONE:
        frac = 0.5 if cfg.rope_mode is RopeMode.HALF else 1.0
        cos, sin = rope_tables(S, int(hd * frac), cfg.rope_theta, pos_offset,
                               device=x.device)
        q = apply_rope(q, cos, sin, frac)
        k = apply_rope(k, cos, sin, frac)

    window = cfg.local_window if kind is BlockKind.ATTN_LOCAL else None
    scale = hd ** -0.5
    if cache is None:
        k_att, v_att, kv_valid, new_cache = k, v, None, None
    elif block_table is None:
        # dense stripes: write at pos, attend over the whole stripe
        kv_valid = cache["pos"] + S
        k_att = _cache_write(cache["k"], k, cache["pos"])
        v_att = _cache_write(cache["v"], v, cache["pos"])
        new_cache = {"k": k_att, "v": v_att, "pos": kv_valid}
    else:
        adv = S if pos_advance is None else pos_advance
        kv_valid = cache["pos"] + adv
        if "k_scale" in cache:
            ck, cks = _paged_write_quant(cache["k"], cache["k_scale"], k,
                                         cache["pos"], block_table)
            cv, cvs = _paged_write_quant(cache["v"], cache["v_scale"], v,
                                         cache["pos"], block_table)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs,
                         "pos": kv_valid}
        else:
            cks = cvs = None
            ck = _paged_write(cache["k"], k, cache["pos"], block_table)
            cv = _paged_write(cache["v"], v, cache["pos"], block_table)
            new_cache = {"k": ck, "v": cv, "pos": kv_valid}
        if S == 1:
            out = PA.decode_attention(
                q.reshape(B, KV, G, hd), ck, cv, block_table,
                kv_valid.to(torch.int32), scale=scale, window=window,
                logit_cap=cfg.attn_logit_softcap, k_scale=cks, v_scale=cvs,
                device=x.device)
            return dense(out.reshape(B, 1, H * hd), p["wo"],
                         backend=backend), new_cache
        k_att = PA.gather_pool_blocks(ck, block_table)
        v_att = PA.gather_pool_blocks(cv, block_table)
        if cks is not None:
            # dequantize through the compute dtype, as the reference does
            k_att = k_att.to(x.dtype) * PA.gather_pool_blocks(
                cks, block_table).to(x.dtype)[..., None]
            v_att = v_att.to(x.dtype) * PA.gather_pool_blocks(
                cvs, block_table).to(x.dtype)[..., None]
    out = _flash(q.reshape(B, S, KV, G, hd), k_att, v_att, scale=scale,
                 causal=cfg.causal, window=window, q_offset=pos_offset,
                 kv_valid=kv_valid, logit_cap=cfg.attn_logit_softcap,
                 block=cfg.attn_block_kv)
    return dense(out.reshape(B, S, H * hd), p["wo"],
                 backend=backend), new_cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Empty dense stripes of one attention block: k/v (batch, max_len,
    KV, hd) in ``dtype`` and a scalar ``pos``.  No int8 form under
    ``cfg.quant_kv``, as in the reference (int8 KV is the pool's)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def make_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype: torch.dtype, device: torch.device) -> dict:
    """Empty per-layer paged pool (no batch dim) plus its cursor leaf;
    under ``cfg.quant_kv`` int8 pools with fp32 scale sidecars (initialised
    to 1.0) sharing the (num_blocks, block_size) layout, so block tables
    and COW copies address them like the payload."""
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    if cfg.quant_kv:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(shape[:3], dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones(shape[:3], dtype=torch.float32,
                                      device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
