"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe`` on one device, where its ``moe_apply`` is
``_moe_compute``).

Tokens are expanded ``top_k`` times, sorted by expert id (a stable sort,
as ``jnp.argsort``: the order of dropping depends on it), and each expert
keeps the first ``capacity`` of its slots; the (E, C, D) dispatch runs
the routed experts as three batched products (``torch.bmm``: the
reference computes them outside any Pallas kernel), and each token sums
its k gate-weighted outputs in a fixed order (the same sums run to run
on the card; within 1e-4 of the reference's scatter-add order).  Every
shape is static: experts are counted with ``scatter_add_``, never
``bincount`` or ``nonzero``, so the layer runs under ``FakeTensorMode``
(``launch.step_cost``) and reads no device value.  The router and the
shared expert go through ``layers.dense``, so they run K2 under the
scheduled backend and K3 where a leaf is int8.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import (ParamDef, activation, dense,
                                       mlp_apply, mlp_defs)

#: (expanded slots, capacity, dropped slots) of each call while
#: :func:`record_drops` is active (the count a device tensor, read after
#: the run), else None
_DROPS: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "moe_drops", default=None)


def moe_defs(cfg: ModelConfig) -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    e, f = m.n_experts, m.d_ff_expert
    defs = {
        "router": ParamDef((d, e), scale=0.006),
        "wi_gate": ParamDef((e, d, f)),
        "wi_up": ParamDef((e, d, f)),
        "wo": ParamDef((e, f, d)),
    }
    if m.n_shared_experts:
        defs["shared"] = mlp_defs(
            d, m.d_ff_shared or m.d_ff_expert * m.n_shared_experts)
    return defs


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots an expert keeps: a multiple of 8, at least 8."""
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


@contextlib.contextmanager
def record_drops():
    """Inside, every :func:`moe_apply` call appends (T * top_k, the
    capacity of an expert, its count of dropped (token, expert) slots as
    a device tensor) to the yielded list: no call syncs.  The list is
    the calling thread's (a context variable): an engine stepped from
    its own serve thread records nothing here."""
    drops: list = []
    token = _DROPS.set(drops)
    try:
        yield drops
    finally:
        _DROPS.reset(token)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, backend=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), the Switch aux loss, fp32 scalar)."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = _capacity(T, m)
    dev = x.device
    xf = x.reshape(T, D)

    # routing, in fp32 from the router's product
    logits = dense(xf, p["router"], backend=backend).float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance loss
    experts = torch.arange(E, device=dev)
    ce = (expert_ids[:, :1] == experts).float().mean(0)
    aux = m.aux_loss_weight * E * (probs.mean(0) * ce).sum()

    # sort-based dispatch: slot s of the expanded tokens -> expert slot
    flat_ids = expert_ids.reshape(T * K)
    flat_gates = gate_vals.reshape(T * K)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    starts = counts.cumsum(0) - counts                       # exclusive
    pos_in_expert = torch.arange(T * K, device=dev) - starts[sorted_ids]
    keep = pos_in_expert < C
    drops = _DROPS.get()
    if drops is not None:
        drops.append((T * K, C, T * K - keep.sum()))
    slot = torch.where(keep, sorted_ids * C + pos_in_expert,
                       torch.full_like(sorted_ids, E * C))
    # slot (E*C) -> expanded index, T*K where empty; the dropped entries
    # all land in the extra last element, which is cut off
    gather_idx = torch.full((E * C + 1,), T * K, dtype=torch.long,
                            device=dev).scatter_(0, slot, order)[:E * C]
    token_of = gather_idx.div(K, rounding_mode="floor").clamp_max(T)
    pad_x = torch.cat([xf, xf.new_zeros(1, D)])
    gathered = pad_x[token_of].reshape(E, C, D)

    # the routed experts: three batched products over (E, C, .)
    dt = gathered.dtype
    g = activation(torch.bmm(gathered, p["wi_gate"].to(dt)), cfg.act)
    u = torch.bmm(gathered, p["wi_up"].to(dt))
    y = torch.bmm(g * u, p["wo"].to(dt))

    # gate-weighted combine in a fixed order: each kept slot's output goes
    # back to its expanded index (written once; the empty slots' zero
    # rows all land in the extra row T*K, which is cut off, and a dropped
    # slot's row stays zero), then each token sums its k rows in top-k
    # order.  An ``index_add_`` into the tokens would order a token's
    # adds by the card's atomics: with k >= 3 its sums, and so the greedy
    # tokens, would move from run to run
    pad_gates = torch.cat([flat_gates, flat_gates.new_zeros(1)])
    slot_gate = pad_gates[gather_idx.clamp_max(T * K)]
    y = y.reshape(E * C, D) * slot_gate[:, None].to(y.dtype)
    per_slot = y.new_zeros(T * K + 1, D).index_copy_(0, gather_idx, y)
    out = per_slot[:T * K].view(T, K, D).sum(dim=1)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], xf, cfg.act, backend=backend)
    return out.reshape(B, S, D).to(x.dtype), aux
