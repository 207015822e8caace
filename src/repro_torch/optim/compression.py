"""int8 gradient compression with error feedback for the data-parallel
all-reduce (port of ``repro.optim.compression``).

Quantizing the payload to int8 with a per-tensor scale cuts it 4x (vs
fp32); stochastic rounding keeps the quantizer unbiased and the
error-feedback buffer re-injects the residual next step.  The rounding is
``_round(x, u)`` on explicit uniform draws ``u``; ``compress`` draws them
from a ``torch.Generator``.  The compressed data-parallel train step of
the reference (a ``shard_map`` over a data axis) waits for the port's
multi-device work; these functions are its per-device half.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import tree_map
from repro_torch.optim.adamw import leaves

PyTree = Any


def _round(x: torch.Tensor, u: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization of ``x`` given uniform draws
    ``u`` in [0, 1) of its shape: (q int8, scale fp32 scalar, err fp32 =
    x - dequant(q)).  E[dequant(q)] == x over u."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = xf / scale
    lo = torch.floor(y)
    p_up = y - lo                       # in [0,1)
    q = torch.clamp(lo + (u < p_up).float(), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    return q, scale, err


def compress(x: torch.Tensor, gen: torch.Generator
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_round`` with uniform draws from ``gen`` (on x's device)."""
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return _round(x, u)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: PyTree, err: PyTree, gen: torch.Generator
                  ) -> tuple[PyTree, PyTree, PyTree]:
    """Error-feedback compression leaf-wise, draws from ``gen`` in tree
    order.  Returns (q_tree int8, scale_tree, new_err_tree)."""
    out = iter([compress(g.float() + e, gen)
                for g, e in zip(leaves(grads), leaves(err))])
    triples = tree_map(lambda _p, _g: next(out), grads)
    return tuple(tree_map(lambda _p, _g, t, i=i: t[i], grads, triples)
                 for i in range(3))


def decompress_tree(q_tree: PyTree, scale_tree: PyTree) -> PyTree:
    return tree_map(lambda _p, q, s: decompress(q, s), q_tree, scale_tree)


def init_error(params: PyTree) -> PyTree:
    return tree_map(lambda _p, a: torch.zeros(a.shape, dtype=torch.float32,
                                              device=a.device), params)


def wire_bytes(grads: PyTree) -> dict[str, float]:
    """Diagnostic: fp32 vs int8 payload for the DP reduction."""
    n = sum(x.numel() for x in leaves(grads))
    return {"fp32_bytes": 4.0 * n, "int8_bytes": 1.0 * n,
            "ratio": 4.0}
