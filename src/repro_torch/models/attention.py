"""GQA and MLA attention (port of ``repro.models.attention``): the full
sequence, dense KV stripes, and the block-paged KV pool.

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

MLA (deepseek-v2, ``mla_attention``) caches the latent ``c_kv`` (.., r)
and the one shared rope key ``k_pe`` (.., rp) in the compute dtype on the
same three layouts (no int8 form).  Its paged reads gather the slot's
blocks, never the GQA decode kernel.  A decode step (S == 1 over a
cache) scores in latent space: ``wk_b`` folds into the query and ``wv_b``
into the output, so the cache is never decompressed; chunks, verify
steps and the forward decompress k and v per head from the latent.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.models.config import BlockKind, MLAConfig, ModelConfig, \
    RopeMode
from repro_torch.models.layers import ParamDef, apply_rope, dense, \
    rms_norm, rope_tables, softcap

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


def mla_defs(cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank)),
        "q_norm": ParamDef((m.q_lora_rank,), init="zeros"),
        "wq_b": ParamDef((m.q_lora_rank, H * (qk + m.qk_rope_head_dim))),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": ParamDef((m.kv_lora_rank,), init="zeros"),
        "wk_b": ParamDef((m.kv_lora_rank, H * qk)),
        "wv_b": ParamDef((m.kv_lora_rank, H * m.v_head_dim)),
        "wo": ParamDef((H * m.v_head_dim, d)),
    }


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


def _latent_weight(w, r: int, H: int, dtype: torch.dtype) -> torch.Tensor:
    """A decompression weight (r, H * d) as (r, H, d) in ``dtype``; a
    QuantTensor dequantizes straight to ``dtype``, as the reference's
    absorbed decode does."""
    w = w.dequant(dtype) if hasattr(w, "dequant") else w.to(dtype)
    return w.reshape(r, H, -1)


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  pos_offset: torch.Tensor | int = 0,
                  cache: dict | None = None,
                  block_table: torch.Tensor | None = None,
                  pos_advance: torch.Tensor | None = None,
                  backend=None) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention over the full sequence, dense stripes
    or the paged pool (the layouts of :func:`gqa_attention`), caching
    ``c_kv`` and ``k_pe`` only.  The rope covers the ``qk_rope_head_dim``
    dims; the scale is (qk_nope + qk_rope) ** -0.5 on every path.  With a
    cache, S == 1 runs the absorbed decode (latent scores over
    ``[c_kv ; k_pe]``, values ``c_kv``, then ``wv_b``); otherwise k and v
    are decompressed over the whole gathered table."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H, eps = cfg.n_heads, cfg.norm_eps
    qk, rp, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)

    q_lat = rms_norm(dense(x, p["wq_a"], backend=backend), p["q_norm"], eps)
    q = dense(q_lat, p["wq_b"], backend=backend).view(B, S, H, qk + rp)
    q_nope, q_pe = q[..., :qk], q[..., qk:]
    kv_a = dense(x, p["wkv_a"], backend=backend)          # (B, S, r + rp)
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"], eps)
    k_pe = kv_a[..., r:]                                  # one shared head
    cos, sin = rope_tables(S, rp, cfg.rope_theta, pos_offset,
                           device=x.device)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is None:
        c_att, pe_att, kv_valid, new_cache = c_kv, k_pe, None, None
    elif block_table is None:
        kv_valid = cache["pos"] + S
        c_att = _cache_write(cache["c_kv"], c_kv, cache["pos"])
        pe_att = _cache_write(cache["k_pe"], k_pe, cache["pos"])
        new_cache = {"c_kv": c_att, "k_pe": pe_att, "pos": kv_valid}
    else:
        adv = S if pos_advance is None else pos_advance
        kv_valid = cache["pos"] + adv
        ckv = _paged_write(cache["c_kv"], c_kv, cache["pos"], block_table)
        cpe = _paged_write(cache["k_pe"], k_pe, cache["pos"], block_table)
        new_cache = {"c_kv": ckv, "k_pe": cpe, "pos": kv_valid}
        c_att = PA.gather_pool_blocks(ckv, block_table)
        pe_att = PA.gather_pool_blocks(cpe, block_table)
    scale = (qk + rp) ** -0.5
    flash_kw = dict(scale=scale, causal=cfg.causal, window=None,
                    q_offset=pos_offset, kv_valid=kv_valid,
                    logit_cap=cfg.attn_logit_softcap,
                    block=cfg.attn_block_kv)

    if S == 1 and cache is not None:
        # absorbed decode: the query meets the latent cache through wk_b,
        # the latent output leaves through wv_b
        dt = q_nope.dtype
        q_abs = torch.einsum("bshq,rhq->bshr", q_nope,
                             _latent_weight(p["wk_b"], r, H, dt))
        q_eff = torch.cat([q_abs, q_pe], dim=-1)
        k_eff = torch.cat([c_att, pe_att], dim=-1)
        out_lat = _flash(q_eff.reshape(B, 1, 1, H, r + rp),
                         k_eff[:, :, None, :], c_att[:, :, None, :],
                         **flash_kw)
        out = torch.einsum("bshr,rhv->bshv", out_lat.reshape(B, 1, H, r),
                           _latent_weight(p["wv_b"], r, H, dt))
        return dense(out.reshape(B, 1, H * vd), p["wo"],
                     backend=backend), new_cache

    T = c_att.shape[1]
    k_nope = dense(c_att, p["wk_b"], backend=backend).view(B, T, H, qk)
    vv = dense(c_att, p["wv_b"], backend=backend).view(B, T, H, vd)
    k_eff = torch.cat([k_nope, pe_att[:, :, None, :].expand(B, T, H, rp)],
                      dim=-1)
    q_eff = torch.cat([q_nope, q_pe], dim=-1)
    out = _flash(q_eff.reshape(B, S, H, 1, qk + rp), k_eff, vv, **flash_kw)
    return dense(out.reshape(B, S, H * vd), p["wo"],
                 backend=backend), new_cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Empty dense stripes of one attention block: k/v (batch, max_len,
    KV, hd) in ``dtype`` and a scalar ``pos`` (MLA: c_kv (batch, max_len,
    r) and k_pe (batch, max_len, rp)).  No int8 form under
    ``cfg.quant_kv``, as in the reference (int8 KV is the pool's)."""
    if cfg.mla is not None:
        return _latent_cache(cfg, (batch, max_len), dtype, device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def make_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype: torch.dtype, device: torch.device) -> dict:
    """Empty per-layer paged pool (no batch dim) plus its cursor leaf;
    under ``cfg.quant_kv`` int8 pools with fp32 scale sidecars (initialised
    to 1.0) sharing the (num_blocks, block_size) layout, so block tables
    and COW copies address them like the payload.  An MLA pool holds
    c_kv (num_blocks, block_size, r) and k_pe (.., rp) in ``dtype``."""
    if cfg.mla is not None:
        return _latent_cache(cfg, (num_blocks, block_size), dtype, device)
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


def _latent_cache(cfg: ModelConfig, lead: tuple[int, int],
                  dtype: torch.dtype, device: torch.device) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                                device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
