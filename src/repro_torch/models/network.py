"""Network assembly and the paged serving functions (port of the serving
part of ``repro.models.network``, for plain ATTN patterns and for
attention-free MAMBA2 patterns).

Parameters keep the reference's tree: ``{"embed": {"table"}, "final_norm",
"blocks": (group,)}`` with a leading stacked layer dim on every block
leaf.  Paged cache trees keep its layout too:

  ``{"groups": ({"k": (L, nb, bs, KV, hd), "v": ..., "pos": (L, slots)},)}``

where k/v are POOL leaves shared by all slots (indexed through the block
table) and ``pos`` the per-slot write cursors.  Under ``cfg.quant_kv`` k/v
are int8 and the pool also holds the fp32 scale sidecars ``k_scale`` /
``v_scale`` (L, nb, bs, KV).  A MAMBA2 group holds per-slot recurrent
state instead, ``{"conv": (L, slots, K-1, conv_dim), "ssm": (L, slots, H,
P, N)}`` (slot axis 1), and an attention-free tree carries one top-level
cursor ``"pos": (slots,)``.  The serving functions update the pool and
slot-state tensors IN PLACE and return the tree with new cursors.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (ParamDef, embed_apply, embed_defs,
                                       head_apply, init_params, mlp_apply,
                                       mlp_defs, rms_norm, stack_defs,
                                       tree_map)

PyTree = Any

_POOL_KEYS = ("k", "v", "k_scale", "v_scale")
#: per-slot recurrent state of MAMBA2 groups (slot axis 1)
_SLOT_STATE_KEYS = ("conv", "ssm")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_supported(cfg: ModelConfig) -> None:
    if set(cfg.pattern) not in ({BlockKind.ATTN}, {BlockKind.MAMBA2}) \
            or cfg.tail or cfg.moe is not None or cfg.mla is not None \
            or cfg.first_layer_dense_ff or cfg.frontend != "none" \
            or cfg.post_norms or cfg.scale_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only plain ATTN decoder stacks and attention-free "
            f"MAMBA2 stacks are ported so far (see ROADMAP.md for the "
            f"other families)")


def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="zeros")


def _block_defs(cfg: ModelConfig, kind: BlockKind) -> dict:
    d = cfg.d_model
    if kind is BlockKind.MAMBA2:
        return {"ln1": _norm_def(d), "mamba": S.mamba2_defs(cfg)}
    return {"ln1": _norm_def(d), "ln2": _norm_def(d),
            "attn": A.attn_defs(cfg), "mlp": mlp_defs(d, cfg.d_ff)}


def param_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    d = cfg.d_model
    defs: dict = {"final_norm": _norm_def(d),
                  "embed": embed_defs(cfg.vocab, d)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.vocab, d))
    defs["blocks"] = stack_defs(tuple(_block_defs(cfg, k)
                                      for k in cfg.pattern),
                                cfg.n_groups_scan)
    return defs


def init(cfg: ModelConfig, seed: int = 0,
         device: str | torch.device | None = None) -> PyTree:
    """Random parameters with the reference's ParamDef scales, drawn from
    a ``torch.Generator`` seeded with ``seed`` on the target device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(param_defs(cfg), gen, _dtype(cfg.param_dtype), dev)


def gemm_backend(cfg: ModelConfig):
    """The shared scheduled GEMM backend of this config, or None."""
    return OPS.backend_for(cfg)


def _layer(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda _p, a: a[i], tree)


def _run_blocks(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                pos_offset: torch.Tensor, caches: PyTree,
                block_table: torch.Tensor,
                pos_advance: torch.Tensor | None,
                seq_lens: torch.Tensor | None) -> tuple[torch.Tensor,
                                                        PyTree]:
    backend = gemm_backend(cfg)
    eps = cfg.norm_eps
    groups = []
    for gi, kind in enumerate(cfg.pattern):
        stacked, gcache = params["blocks"][gi], caches["groups"][gi]
        if kind is BlockKind.MAMBA2:
            # ``seq_lens`` masks the recurrence of pad positions and of
            # rows riding along (0): their state comes back unchanged
            for li in range(cfg.n_groups_scan):
                p = _layer(stacked, li)
                state = {k: gcache[k][li] for k in _SLOT_STATE_KEYS}
                out, new = S.mamba2_block(p["mamba"],
                                          rms_norm(x, p["ln1"], eps), cfg,
                                          state=state, seq_len=seq_lens,
                                          backend=backend)
                x = x + out
                for k in _SLOT_STATE_KEYS:
                    state[k].copy_(new[k])
            groups.append(gcache)
            continue
        new_pos = []
        pools = [k for k in _POOL_KEYS if k in gcache]
        for li in range(cfg.n_groups_scan):
            p = _layer(stacked, li)
            cache = {k: gcache[k][li] for k in pools}
            cache["pos"] = gcache["pos"][li]
            h = rms_norm(x, p["ln1"], eps)
            out, nc = A.gqa_attention(p["attn"], h, cfg, kind=BlockKind.ATTN,
                                      pos_offset=pos_offset, cache=cache,
                                      block_table=block_table,
                                      pos_advance=pos_advance,
                                      backend=backend)
            x = x + out
            h = rms_norm(x, p["ln2"], eps)
            x = x + mlp_apply(p["mlp"], h, cfg.act, backend=backend)
            new_pos.append(nc["pos"])
        groups.append({**{k: gcache[k] for k in pools},
                       "pos": torch.stack(new_pos)})
    return x, {"groups": tuple(groups)}


def _serve(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
           caches: PyTree, pos_offset: torch.Tensor,
           block_table: torch.Tensor, pos_advance: torch.Tensor | None,
           seq_lens: torch.Tensor | None,
           last_index: torch.Tensor | None = None, all_rows: bool = False
           ) -> tuple[torch.Tensor, PyTree]:
    x = embed_apply(params["embed"], tokens, _dtype(cfg.compute_dtype))
    x, new_caches = _run_blocks(params, cfg, x, pos_offset=pos_offset,
                                caches=caches, block_table=block_table,
                                pos_advance=pos_advance, seq_lens=seq_lens)
    if "pos" in caches:
        # an attention-free tree's cursor: no layer moves it
        adv = 0 if pos_advance is None else pos_advance.to(
            caches["pos"].dtype)
        new_caches["pos"] = caches["pos"] + adv
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"])
    if all_rows:                 # verify: logits at every position
        return head_apply(head, x, cfg.final_logit_softcap,
                          backend=gemm_backend(cfg)), new_caches
    if last_index is not None:   # ragged: each row's last REAL token
        x = torch.gather(x, 1, last_index.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    else:
        x = x[:, -1:]
    logits = head_apply(head, x, cfg.final_logit_softcap,
                        backend=gemm_backend(cfg))
    return logits[:, 0], new_caches


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                caches: PyTree, pos: torch.Tensor,
                block_table: torch.Tensor,
                pos_advance: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, PyTree]:
    """One decode step over the paged pool: tokens (B, 1); pos (B,) the
    per-slot positions; ``pos_advance`` (B,) 1 for the slots that decode
    and 0 for rows riding along (it doubles as the SSM validity mask, so
    a 0-row's recurrent state is untouched).  Returns (logits fp32 (B,
    V), caches); the pools and slot states are written in place."""
    return _serve(params, cfg, tokens, caches, pos, block_table, pos_advance,
                  seq_lens=pos_advance)


def prefill_paged_chunk(params: PyTree, cfg: ModelConfig,
                        tokens: torch.Tensor, caches: PyTree,
                        slot_ids: torch.Tensor, block_rows: torch.Tensor,
                        seq_lens: torch.Tensor, last_index: torch.Tensor
                        ) -> tuple[torch.Tensor, PyTree]:
    """One chunk of ragged prefill for B admission rows: tokens (B, L)
    right-padded, seq_lens (B,) the real token counts (0 = masked row),
    block_rows (B, nbs), last_index (B,) the row whose logits to return.
    Each row starts at its slot's cursor and attends over all of the
    slot's resident KV; cursors advance by ``seq_lens``."""
    lens = seq_lens.to(torch.int32)
    view = gather_slot_view(caches, slot_ids)
    pos0 = _first_pos_leaf(view)
    logits, new_view = _serve(params, cfg, tokens, view, pos0, block_rows,
                              lens, lens, last_index)
    return logits, scatter_slot_view(caches, new_view, slot_ids)


def verify_paged_chunk(params: PyTree, cfg: ModelConfig,
                       tokens: torch.Tensor, caches: PyTree,
                       slot_ids: torch.Tensor, block_rows: torch.Tensor,
                       seq_lens: torch.Tensor) -> tuple[torch.Tensor, PyTree]:
    """Speculative verify step: tokens (B, L) = ``[cur_tok, draft_1 ..
    draft_k]`` right-padded to L = spec_k + 1, seq_lens (B,) the real
    count (0 = masked row).  The chunked prefill's ragged layout, but the
    head applies to all B*L rows -- the ``(B*L, vocab, d)`` GEMM the
    engine registers -- and fp32 logits (B, L, V) come back:
    ``argmax(logits[i, j])`` is the target's token after ``tokens[i, j]``.
    Cursors advance by ``seq_lens`` (full acceptance); a rejection is
    rolled back with :func:`set_slot_pos`."""
    lens = seq_lens.to(torch.int32)
    view = gather_slot_view(caches, slot_ids)
    pos0 = _first_pos_leaf(view)
    logits, new_view = _serve(params, cfg, tokens, view, pos0, block_rows,
                              lens, lens, all_rows=True)
    return logits, scatter_slot_view(caches, new_view, slot_ids)


# ---------------------------------------------------------------------------
# Paged cache trees
# ---------------------------------------------------------------------------

def init_paged_caches(cfg: ModelConfig, slots: int, num_blocks: int,
                      block_size: int, dtype: torch.dtype | None = None,
                      device: str | torch.device | None = None) -> PyTree:
    """Cache tree for block-paged serving: attention leaves become shared
    pools, SSM state stays per slot (it is O(1) per slot: nothing to
    page).  Callers still ``expand_cache_pos(tree, slots)`` so each slot
    has its own cursor."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.compute_dtype)

    def group(kind):
        if kind is BlockKind.MAMBA2:
            one = S.make_ssm_state(cfg, slots, dtype, dev)
            return {k: one[k].new_zeros((cfg.n_groups_scan,)
                                        + tuple(one[k].shape))
                    for k in one}
        per_layer = [A.make_paged_kv_cache(cfg, num_blocks, block_size,
                                           dtype, dev)
                     for _ in range(cfg.n_groups_scan)]
        return {k: torch.stack([c[k] for c in per_layer])
                for k in per_layer[0]}
    caches: dict = {"groups": tuple(group(k) for k in cfg.pattern)}
    if cfg.attention_free:
        # no layer carries a cursor, but the paged entry points read each
        # row's from the tree (``_first_pos_leaf``): one top-level cursor,
        # advanced by ``_serve``
        caches["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return caches


def _is_pos(path: tuple) -> bool:
    return "pos" in path


def expand_cache_pos(caches: PyTree, batch: int) -> PyTree:
    """Per-slot cursors: every ``pos`` leaf gains a trailing (batch,) dim."""
    return tree_map(lambda path, a: torch.zeros(
        tuple(a.shape) + (batch,), dtype=a.dtype, device=a.device)
        if _is_pos(path) else a, caches)


def _is_slot_state(path: tuple) -> bool:
    return path[-1] in _SLOT_STATE_KEYS


def gather_slot_view(caches: PyTree, slot_ids: torch.Tensor) -> PyTree:
    """B-row view for the rows ``slot_ids``: cursors and slot state are
    gathered, pool leaves pass through whole (writes go through the
    block table)."""
    ids = slot_ids.long()

    def fn(path, a):
        if _is_pos(path):
            return a.index_select(-1, ids)
        if _is_slot_state(path):
            return a.index_select(1, ids)
        return a
    return tree_map(fn, caches)


def scatter_slot_view(caches: PyTree, view: PyTree, slot_ids: torch.Tensor
                      ) -> PyTree:
    """Merge an updated view back: cursors scatter at the DISTINCT
    ``slot_ids``, slot state scatters there in place; pool leaves are the
    view's (already written in place)."""
    ids = slot_ids.long()

    def fn(path, big, small):
        if _is_pos(path):
            out = big.clone()
            out[..., ids] = small.to(big.dtype)
            return out
        if _is_slot_state(path):
            return big.index_copy_(1, ids, small.to(big.dtype))
        return small
    return tree_map(fn, caches, view)


def set_slot_pos(caches: PyTree, pos: torch.Tensor) -> PyTree:
    """Overwrite every per-slot cursor with ``pos`` (slots,)."""
    return tree_map(lambda path, a: pos.to(a.dtype).expand_as(a).clone()
                    if _is_pos(path) else a, caches)


def _first_pos_leaf(view: PyTree) -> torch.Tensor:
    """The per-row cursor vector of a view (every layer's cursor moves in
    lockstep; stacked leaves carry (L, B) -- take layer 0; an
    attention-free tree has only its top-level cursor)."""
    leaf = view["pos"] if "pos" in view else view["groups"][0]["pos"]
    return (leaf[0] if leaf.dim() == 2 else leaf).to(torch.int32)


def reset_slot_state(caches: PyTree, slot: int, pos_value: int) -> PyTree:
    """Fresh-request reset of one slot: its cursors become ``pos_value``
    (the resident shared-prefix length) and its recurrent state is
    zeroed in place.  Pool leaves are untouched."""
    def fn(path, a):
        if _is_slot_state(path):
            a[:, slot] = 0
            return a
        if not _is_pos(path):
            return a
        out = a.clone()
        out[..., slot] = pos_value
        return out
    return tree_map(fn, caches)


def copy_paged_blocks(caches: PyTree, src: torch.Tensor, dst: torch.Tensor
                      ) -> PyTree:
    """Copy pool blocks ``src[i] -> dst[i]`` in every pool leaf, in place
    (copy-on-write forks).  Slot state is untouched."""
    s, d = src.long(), dst.long()

    def fn(path, a):
        if path[-1] in _POOL_KEYS:
            a[:, d] = a[:, s]
        return a
    return tree_map(fn, caches)


def kv_cache_bytes(caches: PyTree) -> int:
    """Bytes of the attention KV pool leaves (0 for an attention-free
    tree: slot state and cursors are not counted)."""
    total = 0

    def fn(path, a):
        nonlocal total
        if path[-1] in _POOL_KEYS:
            total += a.numel() * a.element_size()
        return a
    tree_map(fn, caches)
    return total
