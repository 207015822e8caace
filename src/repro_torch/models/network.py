"""Network assembly, the full-sequence forward, the training loss and the
serving functions, dense and paged (port of ``repro.models.network``):
decoder stacks of ATTN and ATTN_LOCAL blocks (GQA or, where ``cfg.mla``,
MLA; sandwich norms, scaled embeddings and softcaps by config; a dense
MLP or, where ``cfg.moe``, the MoE FFN of ``models.moe``), with
deepseek-v2's dense first block ahead of the groups where
``cfg.first_layer_dense_ff``, attention-free MAMBA2 stacks, and zamba2's
hybrid of MAMBA2 blocks, shared attention and a MAMBA2 tail, and
hubert's encoder (bidirectional attention over projected frames).

Parameters keep the reference's tree: ``{"embed": {"table"}, "final_norm",
"blocks": (group,)}`` with a leading stacked group dim on every block
leaf, and where the config asks for them ``lm_head``, ``vision_proj``,
``tail_blocks`` (a tuple of unstacked blocks), ``first_block`` (one
unstacked block with a dense MLP of ``first_layer_dense_ff``) and
``shared_attn`` (the ``n_shared_attn_sets`` attention sets, stacked).
The frames frontend has no ``embed``: ``frame_proj`` ``{"w" (d, d), "b"
(d,)}`` projects ``batch["frames"]`` (B, S, d) and an untied ``lm_head``
classifies every frame.  The first block runs first, then the groups,
each group's kinds in pattern order, as the reference's scan does, then
the tail.  Dense cache trees (``init_caches``) keep its layout:

  ``{"first": {"k": (B, max_len, KV, hd), ...}, "groups": ({"k": (G, B,
  max_len, KV, hd), "v": ..., "pos": (G,)}, ...), "tail": ({"conv": (B,
  ...), "ssm": ...},)}``

with a scalar ``pos`` a layer (``expand_cache_pos`` makes it (B,) a
layer for the continuous engine's slots) and no int8 form.  Paged cache
trees keep its layout too:

  ``{"groups": ({"k": (G, nb, bs, KV, hd), "v": ..., "pos": (G, slots)},
  ...), "tail": ({"conv": (slots, ...), "ssm": ...},)}``

where k/v are POOL leaves shared by all slots (indexed through the block
table) and ``pos`` the per-slot write cursors.  Under ``cfg.quant_kv`` k/v
are int8 and the pool also holds the fp32 scale sidecars ``k_scale`` /
``v_scale`` (G, nb, bs, KV).  An MLA pool holds the latent ``c_kv`` (G,
nb, bs, r) and ``k_pe`` (G, nb, bs, rp) instead of k/v.  A MAMBA2
position holds per-slot recurrent state instead, ``{"conv": (G, slots,
K-1, conv_dim), "ssm": (G, slots, H, P, N)}``; leaves under ``"groups"``
carry the group dim first (slot or block axis 1), tail and ``"first"``
leaves none (axis 0; the first block's ``pos`` is (slots,)).  An
attention-free tree carries one top-level cursor ``"pos": (slots,)``.
The serving functions update the pool and slot-state tensors IN PLACE
and return the tree with new cursors.

llava's patch prefix (``batch["patches"]`` (B, P, D) through
``vision_proj``, ahead of the tokens, so text positions start at P) enters
through ``forward`` and the dense ``prefill`` / ``prefill_ragged``; the
paged entry points and decode steps take tokens only, as the reference's
do.

Training (``loss_fn``) runs the forward under autograd: each block's MoE
load-balancing loss is summed over the first block, the groups and the
tail, and under ``cfg.remat`` each group of the pattern is wrapped in
``torch.utils.checkpoint`` (non-reentrant), as the reference checkpoints
its scan body; the serving functions run without a graph and never
checkpoint.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as OPS
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (ParamDef, dense, embed_apply,
                                       embed_defs, head_apply, init_params,
                                       mlp_apply, mlp_defs, rms_norm,
                                       stack_defs, tree_map)

PyTree = Any

_POOL_KEYS = ("k", "v", "k_scale", "v_scale", "c_kv", "k_pe")
#: per-slot recurrent state of MAMBA2 blocks
_SLOT_STATE_KEYS = ("conv", "ssm")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="zeros")


def _block_defs(cfg: ModelConfig, kind: BlockKind, *, dense_ff: int = 0
                ) -> dict:
    d = cfg.d_model
    if kind is BlockKind.MAMBA2:
        return {"ln1": _norm_def(d), "mamba": S.mamba2_defs(cfg)}
    if kind is BlockKind.SHARED_ATTN:
        # the weights live in the shared stack; the block keeps its own
        # (unused) norm, as the reference's does
        return {"ln1": _norm_def(d)}
    defs = {"ln1": _norm_def(d), "ln2": _norm_def(d),
            "attn": A.mla_defs(cfg) if cfg.mla is not None
            else A.attn_defs(cfg)}
    if cfg.post_norms:
        defs["post_ln1"] = _norm_def(d)
        defs["post_ln2"] = _norm_def(d)
    if dense_ff:
        defs["mlp"] = mlp_defs(d, dense_ff)
    elif cfg.moe is not None:
        defs["moe"] = M.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    defs: dict = {"final_norm": _norm_def(d)}
    if cfg.frontend != "frames":
        defs["embed"] = embed_defs(cfg.vocab, d)
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((cfg.vocab, d))
    else:
        defs["frame_proj"] = {"w": ParamDef((d, d)),
                              "b": ParamDef((d,), init="zeros")}
        defs["lm_head"] = ParamDef((cfg.vocab, d))
    if cfg.frontend == "patches":
        defs["vision_proj"] = {"w": ParamDef((d, d)),
                               "b": ParamDef((d,), init="zeros")}
    defs["blocks"] = stack_defs(tuple(_block_defs(cfg, k)
                                      for k in cfg.pattern),
                                cfg.n_groups_scan)
    if cfg.tail:
        defs["tail_blocks"] = tuple(_block_defs(cfg, k) for k in cfg.tail)
    if cfg.first_layer_dense_ff:
        defs["first_block"] = _block_defs(cfg, BlockKind.ATTN,
                                          dense_ff=cfg.first_layer_dense_ff)
    if BlockKind.SHARED_ATTN in cfg.pattern + cfg.tail:
        defs["shared_attn"] = stack_defs(
            {"ln1": _norm_def(d), "attn": A.attn_defs(cfg)},
            cfg.n_shared_attn_sets)
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


def _unstack(tree: PyTree, n: int) -> list[PyTree]:
    """The ``n`` layers of a stacked tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients once, where indexing each layer
    adds a zero-filled gradient of the whole stack for every layer."""
    parts: list = []
    tree_map(lambda _p, a: parts.append(
        a.unbind(0) if isinstance(a, torch.Tensor)
        else [a[g] for g in range(n)]), tree)      # a QuantTensor

    def layer(g):
        it = iter(parts)
        return tree_map(lambda _p, _a: next(it)[g], tree)
    return [layer(g) for g in range(n)]


def _apply_block(cfg: ModelConfig, kind: BlockKind, p: dict,
                 x: torch.Tensor, cache: dict | None, shared: dict | None, *,
                 pos_offset: torch.Tensor | int,
                 block_table: torch.Tensor | None,
                 pos_advance: torch.Tensor | None,
                 seq_lens: torch.Tensor | None, backend
                 ) -> tuple[torch.Tensor, torch.Tensor | None,
                            torch.Tensor | None]:
    """One block over its cache (per-slot state, dense stripes or pool
    leaves, and the cursor of this layer), or over none (the forward).
    Recurrent state is written in place; returns (x, the attention cursor
    after the call, or None for a MAMBA2 block or without a cache, the
    MoE aux loss or None).  The FFN is the block's ``moe`` where it has
    one, else its ``mlp`` (the first block's dense MLP among them)."""
    eps = cfg.norm_eps
    if kind is BlockKind.MAMBA2:
        # ``seq_lens`` masks the recurrence of pad positions and of rows
        # riding along (0): their state comes back unchanged
        state = (None if cache is None
                 else {k: cache[k] for k in _SLOT_STATE_KEYS})
        out, new = S.mamba2_block(p["mamba"], rms_norm(x, p["ln1"], eps),
                                  cfg, state=state, seq_len=seq_lens,
                                  backend=backend)
        if state is not None:
            for k in _SLOT_STATE_KEYS:
                state[k].copy_(new[k])
        return x + out, None, None
    attn_kw = dict(pos_offset=pos_offset, cache=cache,
                   block_table=block_table, pos_advance=pos_advance,
                   backend=backend)
    if kind is BlockKind.SHARED_ATTN:
        out, nc = A.gqa_attention(shared["attn"],
                                  rms_norm(x, shared["ln1"], eps), cfg,
                                  kind=BlockKind.ATTN, **attn_kw)
        return x + out, None if nc is None else nc["pos"], None
    h = rms_norm(x, p["ln1"], eps)
    if cfg.mla is not None:
        out, nc = A.mla_attention(p["attn"], h, cfg, **attn_kw)
    else:
        out, nc = A.gqa_attention(p["attn"], h, cfg, kind=kind, **attn_kw)
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln1"], eps)
    x = x + out
    h = rms_norm(x, p["ln2"], eps)
    aux = None
    if "moe" in p:
        out, aux = M.moe_apply(p["moe"], h, cfg, backend=backend)
    else:
        out = mlp_apply(p["mlp"], h, cfg.act, backend=backend)
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln2"], eps)
    return x + out, None if nc is None else nc["pos"], aux


def _block_cache(tree: dict, i: int) -> dict:
    """The cache of one block: layer ``i`` of a group-stacked cache."""
    return {k: a[i] for k, a in tree.items()}


def _run_blocks(params: PyTree, cfg: ModelConfig, x: torch.Tensor, *,
                pos_offset: torch.Tensor | int, caches: PyTree | None,
                block_table: torch.Tensor | None = None,
                pos_advance: torch.Tensor | None = None,
                seq_lens: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, PyTree | None, torch.Tensor | None]:
    """The first block, the pattern groups in order (each group's kinds
    in pattern order), then the tail blocks; returns (x, the cache tree
    with new cursors, or None without one, the summed MoE aux loss, an
    fp32 scalar, or None without MoE blocks).  ``block_table`` None:
    dense stripes.  Under ``cfg.remat``, a forward without caches that
    builds a graph recomputes each group in the backward
    (``torch.utils.checkpoint``, non-reentrant: launch counters and
    ``moe.record_drops`` tick again on the recompute)."""
    backend = gemm_backend(cfg)
    kw = dict(pos_offset=pos_offset, block_table=block_table,
              pos_advance=pos_advance, seq_lens=seq_lens, backend=backend)
    aux = None
    out: dict = {}
    if "first_block" in params:
        fcache = None if caches is None else caches["first"]
        x, pos, a = _apply_block(cfg, BlockKind.ATTN, params["first_block"],
                                 x, fcache, None, **kw)
        if a is not None:
            aux = a if aux is None else aux + a
        if fcache is not None:
            out["first"] = {**fcache, "pos": pos}
    n_pat = len(cfg.pattern)
    new_pos: list[list[torch.Tensor]] = [[] for _ in range(n_pat)]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    n_groups = cfg.n_groups_scan
    layers = [_unstack(b, n_groups) for b in params["blocks"]]
    if "shared_attn" in params:
        shared_sets = _unstack(params["shared_attn"], cfg.n_shared_attn_sets)
    for gi in range(n_groups):
        shared = None
        if "shared_attn" in params:
            shared = shared_sets[gi % cfg.n_shared_attn_sets]

        def group(x, aux, gi=gi, shared=shared):
            for i, kind in enumerate(cfg.pattern):
                x, pos, a = _apply_block(
                    cfg, kind, layers[i][gi], x,
                    None if caches is None
                    else _block_cache(caches["groups"][i], gi), shared, **kw)
                if a is not None:
                    aux = a if aux is None else aux + a
                if pos is not None:
                    new_pos[i].append(pos)
            return x, aux
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                group, x, aux, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = group(x, aux)
    tail = []
    for i, kind in enumerate(cfg.tail):
        tcache = None if caches is None else caches["tail"][i]
        x, pos, a = _apply_block(cfg, kind, params["tail_blocks"][i], x,
                                 tcache, None, **kw)
        if a is not None:
            aux = a if aux is None else aux + a
        tail.append(tcache if pos is None else {**tcache, "pos": pos})
    if caches is None:
        return x, None, aux
    out["groups"] = tuple(
        {**gcache, "pos": torch.stack(new_pos[i])} if new_pos[i] else gcache
        for i, gcache in enumerate(caches["groups"]))
    if cfg.tail:
        out["tail"] = tuple(tail)
    return x, out, aux


def _embed_inputs(params: PyTree, cfg: ModelConfig, batch: dict
                  ) -> torch.Tensor:
    """Token embeddings, with llava's projected patch embeddings
    (``batch["patches"]`` (B, P, D)) ahead of them where given; the
    sqrt(d) scale applies to the tokens only, as in the reference.  The
    frames frontend projects ``batch["frames"]`` (B, S, D) instead."""
    dt = _dtype(cfg.compute_dtype)
    if cfg.frontend == "frames":
        return dense(batch["frames"].to(dt), params["frame_proj"]["w"],
                     params["frame_proj"]["b"], backend=gemm_backend(cfg))
    x = embed_apply(params["embed"], batch["tokens"], dt)
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the compute dtype first, as the
        # reference does (in bf16, sqrt(3584) does not round to itself)
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    if cfg.frontend == "patches" and "patches" in batch:
        pe = dense(batch["patches"].to(dt), params["vision_proj"]["w"],
                   params["vision_proj"]["b"], backend=gemm_backend(cfg))
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(params: PyTree, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """The final norm and the head: fp32 logits (B, S, V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"])
    return head_apply(head, x, cfg.final_logit_softcap,
                      backend=gemm_backend(cfg))


def _forward(params: PyTree, cfg: ModelConfig, batch: dict
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``forward``: (fp32 logits (B, S, V), the summed
    MoE aux loss, fp32 scalar)."""
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = _run_blocks(params, cfg, x, pos_offset=0, caches=None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def forward(params: PyTree, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence forward: fp32 logits (B, S, V) at every position
    (patch positions included; every frame of the frames frontend).  The
    reference's second output, the MoE aux loss, enters ``loss_fn``."""
    return _forward(params, cfg, batch)[0]


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Token-level cross-entropy (labels == -1 masked) plus the MoE aux
    loss: (loss, {"ce", "aux", "tokens"}), fp32 scalars.  Under
    ``patches`` the labels align to the text suffix of the logits."""
    logits, aux = _forward(params, cfg, batch)
    labels = batch["labels"].long()
    if cfg.frontend == "patches":
        logits = logits[:, -labels.shape[1]:]
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    ce = ((lse - gold) * mask).sum()
    denom = mask.sum().clamp_min(1.0)
    return ce / denom + aux, {"ce": ce / denom, "aux": aux,
                              "tokens": mask.sum()}


def _serve(params: PyTree, cfg: ModelConfig, batch: dict,
           caches: PyTree, pos_offset: torch.Tensor | int,
           block_table: torch.Tensor | None = None,
           pos_advance: torch.Tensor | None = None,
           seq_lens: torch.Tensor | None = None,
           last_index: torch.Tensor | None = None, all_rows: bool = False
           ) -> tuple[torch.Tensor, PyTree]:
    x = _embed_inputs(params, cfg, batch)
    x, new_caches, _aux = _run_blocks(
        params, cfg, x, pos_offset=pos_offset, caches=caches,
        block_table=block_table, pos_advance=pos_advance, seq_lens=seq_lens)
    if "pos" in caches:
        # an attention-free tree's cursor: no layer moves it
        adv = 0 if pos_advance is None else pos_advance.to(
            caches["pos"].dtype)
        new_caches["pos"] = caches["pos"] + adv
    if all_rows:                 # verify: logits at every position
        return _logits(params, cfg, x), new_caches
    if last_index is not None:   # ragged: each row's last REAL token
        x = torch.gather(x, 1, last_index.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    else:
        x = x[:, -1:]
    return _logits(params, cfg, x)[:, 0], new_caches


def prefill(params: PyTree, cfg: ModelConfig, batch: dict, caches: PyTree
            ) -> tuple[torch.Tensor, PyTree]:
    """The prompt (``batch["tokens"]`` (B, S), llava's
    ``batch["patches"]`` ahead of it) into dense caches from position 0;
    returns (next-token logits fp32 (B, V), caches written in place)."""
    return _serve(params, cfg, batch, caches, 0)


def prefill_ragged(params: PyTree, cfg: ModelConfig, batch: dict,
                   caches: PyTree, last_index: torch.Tensor
                   ) -> tuple[torch.Tensor, PyTree]:
    """``prefill`` of right-padded prompts (real tokens first): logits at
    each row's ``last_index`` (B,), its last REAL token.  The pad tail
    writes KV past each prompt that the caller masks (cursor = the true
    length) and decode overwrites; recurrent state takes the masked
    update (pads get dt == 0), so it is the state after the last real
    token."""
    idx = last_index.to(torch.int32)
    return _serve(params, cfg, batch, caches, 0, seq_lens=idx + 1,
                  last_index=idx)


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                caches: PyTree, pos: torch.Tensor,
                block_table: torch.Tensor | None = None,
                pos_advance: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, PyTree]:
    """One decode step: tokens (B, 1); ``pos`` a scalar (a uniform wave)
    or (B,) per-slot positions.  Without ``block_table`` the caches are
    dense stripes (every row writes at its ``pos``, clamped to the last
    row, and every recurrent state updates).  With it they are the paged
    pool, and ``pos_advance`` (B,) is 1 for the slots that decode and 0
    for rows riding along (it doubles as the SSM validity mask, so a
    0-row's recurrent state is untouched).  Returns (logits fp32 (B, V),
    caches); stripes, pools and slot states are written in place."""
    return _serve(params, cfg, {"tokens": tokens}, caches, pos, block_table,
                  pos_advance, seq_lens=pos_advance)


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
    logits, new_view = _serve(params, cfg, {"tokens": tokens}, view, pos0,
                              block_rows, lens, lens, last_index)
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
    logits, new_view = _serve(params, cfg, {"tokens": tokens}, view, pos0,
                              block_rows, lens, lens, all_rows=True)
    return logits, scatter_slot_view(caches, new_view, slot_ids)


# ---------------------------------------------------------------------------
# Dense cache trees
# ---------------------------------------------------------------------------

def _stack_groups(cfg: ModelConfig, block) -> tuple:
    """Per pattern position, ``block(kind)`` for every group, stacked."""
    def group(kind):
        per_layer = [block(kind) for _ in range(cfg.n_groups_scan)]
        return {k: torch.stack([c[k] for c in per_layer])
                for k in per_layer[0]}
    return tuple(group(k) for k in cfg.pattern)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype | None = None,
                device: str | torch.device | None = None) -> PyTree:
    """Dense cache tree: KV stripes (batch, max_len) per attention layer,
    recurrent state per MAMBA2 layer; groups stacked, the tail
    unstacked.  Cursors are scalars (``expand_cache_pos`` gives each
    slot its own)."""
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.compute_dtype)

    def block(kind):
        if kind is BlockKind.MAMBA2:
            return S.make_ssm_state(cfg, batch, dtype, dev)
        return A.make_kv_cache(cfg, batch, max_len, dtype, dev)
    caches: dict = {}
    if cfg.first_layer_dense_ff:
        caches["first"] = block(BlockKind.ATTN)
    caches["groups"] = _stack_groups(cfg, block)
    if cfg.tail:
        caches["tail"] = tuple(block(k) for k in cfg.tail)
    return caches


def insert_slot_caches(caches: PyTree, slot_caches: PyTree, slot: int,
                       pos_value: int) -> PyTree:
    """Copy a freshly prefilled batch-1 tree into slot ``slot`` of a
    per-slot dense tree, in place: leaves under ``groups`` take the slot
    on axis 1, tail leaves on axis 0, and the slot's cursors become
    ``pos_value`` (the true prompt length, not the padded bucket)."""
    def fn(path, big, small):
        if _is_pos(path):
            out = big.clone()
            out[..., slot] = pos_value
            return out
        ax = _axis(path)
        big.select(ax, slot).copy_(small.select(ax, 0))
        return big
    return tree_map(fn, caches, slot_caches)


# ---------------------------------------------------------------------------
# Paged cache trees
# ---------------------------------------------------------------------------

def init_paged_caches(cfg: ModelConfig, slots: int, num_blocks: int,
                      block_size: int, dtype: torch.dtype | None = None,
                      device: str | torch.device | None = None) -> PyTree:
    """Cache tree for block-paged serving: attention leaves become shared
    pools, SSM state stays per slot (it is O(1) per slot: nothing to
    page); each SHARED_ATTN position has its own pool.  Callers still
    ``expand_cache_pos(tree, slots)`` so each slot has its own cursor."""
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.compute_dtype)

    def block(kind):
        if kind is BlockKind.MAMBA2:
            return S.make_ssm_state(cfg, slots, dtype, dev)
        return A.make_paged_kv_cache(cfg, num_blocks, block_size, dtype,
                                     dev)

    caches: dict = {}
    if cfg.first_layer_dense_ff:
        caches["first"] = block(BlockKind.ATTN)
    caches["groups"] = _stack_groups(cfg, block)
    if cfg.tail:
        caches["tail"] = tuple(block(k) for k in cfg.tail)
    if cfg.attention_free:
        # no layer carries a cursor, but the paged entry points read each
        # row's from the tree (``_first_pos_leaf``): one top-level cursor,
        # advanced by ``_serve``
        caches["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return caches


def _is_pos(path: tuple) -> bool:
    return "pos" in path


def _axis(path: tuple) -> int:
    """The slot (state) or block (pool) axis of a leaf: 1 under the
    group-stacked ``"groups"``, 0 in the tail and in ``"first"``."""
    return 1 if path and path[0] == "groups" else 0


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
            return a.index_select(_axis(path), ids)
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
            return big.index_copy_(_axis(path), ids, small.to(big.dtype))
        return small
    return tree_map(fn, caches, view)


def set_slot_pos(caches: PyTree, pos: torch.Tensor) -> PyTree:
    """Overwrite every per-slot cursor with ``pos`` (slots,)."""
    return tree_map(lambda path, a: pos.to(a.dtype).expand_as(a).clone()
                    if _is_pos(path) else a, caches)


def _first_pos_leaf(view: PyTree) -> torch.Tensor:
    """The per-row cursor vector of a view: every cursor moves in
    lockstep, so the first ``pos`` leaf found is THE cursor (stacked
    leaves carry (G, B) -- take group 0).  A hybrid tree's first group may
    be a MAMBA2 position with no cursor; an attention-free tree has only
    its top-level one."""
    found: list[torch.Tensor] = []

    def fn(path, a):
        if _is_pos(path) and not found:
            found.append(a)
        return a
    tree_map(fn, view)
    if not found:
        raise ValueError("no pos leaf in cache view")
    leaf = found[0]
    return (leaf[0] if leaf.dim() == 2 else leaf).to(torch.int32)


def reset_slot_state(caches: PyTree, slot: int, pos_value: int) -> PyTree:
    """Fresh-request reset of one slot: its cursors become ``pos_value``
    (the resident shared-prefix length) and its recurrent state is
    zeroed in place.  Pool leaves are untouched."""
    def fn(path, a):
        if _is_slot_state(path):
            a.select(_axis(path), slot).zero_()
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
            lead = (slice(None),) * _axis(path)
            a[lead + (d,)] = a[lead + (s,)]
        return a
    return tree_map(fn, caches)


def kv_cache_bytes(caches: PyTree) -> int:
    """Bytes of the attention KV leaves, pool or dense stripes (0 for an
    attention-free tree: slot state and cursors are not counted)."""
    total = 0

    def fn(path, a):
        nonlocal total
        if path[-1] in _POOL_KEYS:
            total += a.numel() * a.element_size()
        return a
    tree_map(fn, caches)
    return total
