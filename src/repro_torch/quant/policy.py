"""Precision policy: int8 QuantTensor weights and the §5 precision choice
(port of ``repro.quant.policy``).

``QuantTensor`` holds an int8 payload and an fp32 per-output-channel
scale and stands in for a (K, N) -- or layer-stacked (L, K, N) -- weight:
``models.layers.dense`` and ``kernels.ops.GemmBackend.dense`` dispatch on
it (on its ``q`` and ``scale`` fields, as the reference does), so
quantizing a model for serving is a rewrite of the parameter tree
(``serving_quant_params``).  The tree walker of the port
(``layers.tree_map``) treats a QuantTensor as one leaf; indexing it
slices payload and scale together, which is how the network takes one
layer of a stacked weight.

``choose_precision`` runs the paper's schedule exploration over candidate
precisions of one p-GEMM and returns the one with the least
sum-of-squares cost (the paper's mixed precision and dataflow scheduling,
§5).  Quantization is bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.core.pgemm import PGEMM
from repro_torch.core.precision import BP16, INT8, INT16, Precision
from repro_torch.core.scheduler import GTAConfig, explore
from repro_torch.models.layers import tree_map

PyTree = Any


@dataclasses.dataclass
class QuantTensor:
    """int8 weight ``q`` (..., K, N) and fp32 per-output-channel ``scale``
    (..., N); it mimics the float weight it replaces."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def __getitem__(self, idx) -> QuantTensor:
        """Slice the leading (layer) dims of payload and scale alike."""
        return QuantTensor(self.q[idx], self.scale[idx])

    def dequant(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """Straight to ``dtype`` (every int8 value is exact in bf16 and
        fp32): q * scale, both in ``dtype``."""
        return self.q.to(dtype) * self.scale.to(dtype)[..., None, :]


def quantize_tensor(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel int8 of a (K, N) or stacked (L, K, N)
    weight: scale = amax over K / 127 (1.0 for an all-zero channel),
    q = clip(round(w / scale), -127, 127) with round-half-to-even."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantTensor(q, scale.squeeze(-2))


DEFAULT_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up",
                      "wq_b", "wk_b", "wv_b", "in_proj", "out_proj")


def quantize_params(params: PyTree,
                    keys: Sequence[str] = DEFAULT_QUANT_KEYS,
                    min_size: int = 1 << 16) -> PyTree:
    """Rewrite the float 2-D / stacked 3-D weights named ``keys`` with at
    least ``min_size`` elements to QuantTensors.  Embeddings, norms and
    biases are untouched; QuantTensor leaves pass through (idempotent)."""
    keys = tuple(keys)

    def fn(path, leaf):
        name = str(path[-1]) if path else ""
        if (name in keys and isinstance(leaf, torch.Tensor)
                and leaf.is_floating_point() and leaf.dim() in (2, 3)
                and leaf.numel() >= min_size):
            return quantize_tensor(leaf)
        return leaf
    return tree_map(fn, params)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What an engine quantizes when ``cfg.quant_serving`` is set."""

    keys: tuple = DEFAULT_QUANT_KEYS
    min_size: int = 1 << 16
    #: an untied lm_head joins the int8 path (its scale folds into the
    #: activation exactly, see ``layers.head_apply``)
    quantize_head: bool = True


@dataclasses.dataclass
class QuantHead(QuantTensor):
    """A quantized untied lm_head, built only by ``head_operand``: its
    (V, D) payload ``q`` is the transposed view of one contiguous (D, V)
    int8 array, the weight K3 takes, so ``q.t()`` is that array with no
    copy; ``unit`` is K3's all-ones output scale (the per-D ``scale``
    folds into x, see ``layers.head_apply``)."""

    unit: torch.Tensor


def head_operand(head: QuantTensor) -> QuantHead:
    """``head`` with its payload stored once, as the contiguous (D, V)
    array the scheduled head runs through K3
    (``kernels.ops.GemmBackend.head``)."""
    if isinstance(head, QuantHead):
        return head
    qt = head.q.t().contiguous()
    return QuantHead(qt.t(), head.scale,
                     torch.ones(qt.shape[1], dtype=torch.float32,
                                device=qt.device))


def serving_quant_params(cfg, params: PyTree,
                         policy: QuantPolicy | None = None) -> PyTree:
    """Apply ``policy`` to a parameter tree for serving under ``cfg``.
    Idempotent; a tied embedding table is never quantized (it feeds the
    token lookup, not only the head).  A quantized untied head is stored
    as K3 takes it (``head_operand``)."""
    policy = policy or QuantPolicy()
    keys = tuple(policy.keys)
    if policy.quantize_head and not cfg.tie_embeddings:
        keys += ("lm_head",)
    out = quantize_params(params, keys=keys, min_size=policy.min_size)
    if isinstance(out.get("lm_head"), QuantTensor):
        out["lm_head"] = head_operand(out["lm_head"])
    return out


def quant_fraction(params: PyTree) -> float:
    """Fraction of parameter bytes stored int8 (diagnostic; as the
    reference, an int8 payload counts one byte an element and its scales
    are not counted)."""
    q = tot = 0

    def fn(_path, leaf):
        nonlocal q, tot
        if isinstance(leaf, QuantTensor):
            q += leaf.q.numel()
            tot += leaf.q.numel()
        elif isinstance(leaf, torch.Tensor):
            tot += leaf.numel() * max(1, leaf.element_size())
        return leaf
    tree_map(fn, params)
    return q / max(tot, 1)


def choose_precision(op: PGEMM,
                     candidates: Sequence[Precision] = (INT8, BP16, INT16),
                     config: GTAConfig | None = None,
                     quality_floor_bits: int = 8) -> Precision:
    """The candidate precision (at least ``quality_floor_bits`` wide)
    whose best schedule has the least sum of squares of the
    min-normalized (cycles, traffic) across candidates; an unschedulable
    candidate is skipped, and with none left the widest is returned."""
    config = config or GTAConfig(lanes=4)
    reports = {}
    for p in candidates:
        if p.mult_bits < quality_floor_bits:
            continue
        try:
            reports[p.name] = explore(dataclasses.replace(op, precision=p),
                                      config).best
        except Exception:  # noqa: BLE001 - an unschedulable precision is
            continue       # skipped: serving needs an answer
    if not reports:
        return max(candidates, key=lambda p: p.mult_bits)
    min_c = max(min(r.cycles for r in reports.values()), 1e-9)
    min_t = max(min(r.traffic_bytes for r in reports.values()), 1e-9)
    best_p, best_score = None, float("inf")
    for p in candidates:
        r = reports.get(p.name)
        if r is None:
            continue
        score = (r.cycles / min_c) ** 2 + (r.traffic_bytes / min_t) ** 2
        if score < best_score:
            best_p, best_score = p, score
    return best_p
