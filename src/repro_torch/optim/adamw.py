"""AdamW + schedules + global-norm clipping over trees of tensors (port of
``repro.optim.adamw``).

Mixed precision: params may be bf16; first/second moments and the update
math run fp32 (``master_copy=True`` keeps a full fp32 master as well).
``step``, the bias corrections and the learning rate are fp32 (``step``
int32) 0-dim tensors on the parameters' device, as the reference's
``jnp`` scalars are, and each expression keeps the reference's order of
operations, so each rounding is the same.

Weight decay follows the reference's mask exactly: a leaf is decayed when
its STACKED array has ``ndim >= 2`` -- so a block's norm scale (G, d) and a
block's bias are decayed, ``final_norm`` (d,) is not.

``update`` writes the new moments and parameters into the given tensors
(the reference's train step donates them) and returns them; it walks a
large stacked leaf one layer at a time, so the fp32 temporaries of the
update stay one layer's size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import tree_map

PyTree = Any

#: stacked leaves with more elements than this are updated a layer at a
#: time (elementwise math: the same result, smaller temporaries)
_SLICE_NUMEL = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_copy: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: PyTree
    v: PyTree
    master: PyTree | None


def leaves(tree: PyTree) -> list[torch.Tensor]:
    """The tensors of a tree (dicts, tuples, lists) in tree order; None
    holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min_ratio * peak (fp32)."""
    s = step.float()
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(s < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params: PyTree) -> AdamWState:
    """Zero fp32 moments shaped like ``params`` (and an fp32 master copy
    with ``master_copy``), ``step`` 0 on the parameters' device."""
    zeros = tree_map(lambda _p, a: torch.zeros(a.shape, dtype=torch.float32,
                                               device=a.device), params)
    master = (tree_map(lambda _p, a: a.detach().float().clone(), params)
              if cfg.master_copy else None)
    dev = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(lambda _p, a: a.clone(), zeros), master)


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    """(fp32 grads scaled to at most ``max_norm`` in global norm, the
    norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda _p, g: g.float() * scale, grads), gn


def _slices(*ts: torch.Tensor):
    """The tensors whole, or layer by layer along a stacked dim 0."""
    t0 = ts[0]
    if t0.dim() >= 3 and t0.numel() > _SLICE_NUMEL:
        return zip(*(t.unbind(0) for t in ts))
    return (ts,)


def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree
           ) -> tuple[PyTree, AdamWState, dict[str, torch.Tensor]]:
    """One AdamW step in place: (params, new state, {"lr", "grad_norm"}),
    the params' and moments' tensors updated.  The gradient is clipped to
    ``clip_norm`` in global norm (the norm before clipping is
    ``grad_norm``); params keep their dtype."""
    with torch.no_grad():
        gn = global_norm(grads)
        scale = _clip_scale(gn, cfg.clip_norm)
        step = state.step + 1
        lr = schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        ps, ms, vs = leaves(params), leaves(state.m), leaves(state.v)
        refs = leaves(state.master) if cfg.master_copy else ps
        for p, g, m, v, r in zip(ps, leaves(grads), ms, vs, refs):
            decay = bool(cfg.weight_decay) and p.dim() >= 2
            for ps_, gs, mm, vv, rs in _slices(p, g, m, v, r):
                g32 = gs.float() * scale
                mm.mul_(b1).add_((1 - b1) * g32)
                vv.mul_(b2).add_((1 - b2) * g32 * g32)
                pf = rs.float()
                u = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
                if decay:
                    u = u + cfg.weight_decay * pf
                new = pf - lr * u
                if cfg.master_copy:
                    rs.copy_(new)
                ps_.copy_(new.to(ps_.dtype))
    return (params, AdamWState(step, state.m, state.v, state.master),
            {"lr": lr, "grad_norm": gn})


def state_logical_axes(param_axes: PyTree, master_copy: bool = False
                       ) -> Any:
    """Optimizer-state axes mirror the params (m/v shard like their
    param); the port runs on one device and keeps them for the
    reference's interface."""
    return AdamWState(
        step=(),
        m=param_axes,
        v=param_axes,
        master=param_axes if master_copy else None,
    )
