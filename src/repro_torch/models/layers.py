"""Layer primitives and the parameter definition system of the port.

Each function mirrors ``repro.models.layers`` (same layouts, same dtype
rules): activations are (B, S, D), weights (K, N), and parameters are
plain nested dicts (and tuples) of tensors, initialized from ``ParamDef``
leaves with an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        return (torch.randn(self.shape, generator=gen, dtype=torch.float32,
                            device=device) * self.scale).to(dtype)


def tree_map(fn, tree: PyTree, *rest: PyTree, path: tuple = ()) -> PyTree:
    """Map ``fn(path, leaf, *leaves)`` over nested dicts/tuples; ``path``
    holds the dict keys and tuple indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def init_params(defs: PyTree, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> PyTree:
    """Materialize a ParamDef tree, leaves drawn in tree order from
    ``gen`` (which must live on ``device``)."""
    return tree_map(lambda _p, d: d.initialize(gen, dtype, device), defs)


def stack_defs(defs: PyTree, n: int) -> PyTree:
    """Prepend a stacked 'layers' dim to every ParamDef in the tree."""
    return tree_map(lambda _p, d: ParamDef((n,) + d.shape, d.init, d.scale),
                    defs)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with a (1 + gamma) scale, computed in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def rope_tables(seq: int, dim: int, theta: float,
                offset: int | torch.Tensor = 0,
                device: torch.device | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, fp32: (seq, dim/2) for a scalar ``offset``,
    (B, seq, dim/2) for a per-slot (B,) ``offset``."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    half = dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=device)
    freqs = 1.0 / (theta ** (idx / half))
    off = torch.as_tensor(offset, dtype=torch.float32, device=device)
    pos = torch.arange(seq, dtype=torch.float32, device=device) + off[..., None]
    ang = pos[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotate_fraction: float = 1.0) -> torch.Tensor:
    """x (B, S, H, D): rotate the first ``rotate_fraction`` of D with the
    split-half convention; tables (S, D/2) or per-slot (B, S, D/2)."""
    d = x.shape[-1]
    rd = int(d * rotate_fraction)
    rd -= rd % 2
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr.chunk(2, dim=-1)
    if cos.dim() == 3:
        c = cos[:, :, None, : rd // 2].to(x.dtype)
        s = sin[:, :, None, : rd // 2].to(x.dtype)
    else:
        c = cos[None, :, None, : rd // 2].to(x.dtype)
        s = sin[None, :, None, : rd // 2].to(x.dtype)
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rot, xp], dim=-1) if rd < d else rot


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None,
          *, backend=None) -> torch.Tensor:
    """x (..., K) @ w (K, N): the product is emitted in the compute dtype,
    the bias is added in fp32, and the result is cast back.  A QuantTensor
    ``w`` multiplies by its int8 payload cast to the compute dtype and
    applies the per-channel scale in the compute dtype too (the
    reference's rounding: a bf16 model rounds the product, then the
    scaled product).  ``backend`` (a ``kernels.ops.GemmBackend``) routes
    the product through the scheduled kernels (mpgemm, or quant_matmul
    for a QuantTensor)."""
    if backend is not None:
        return backend.dense(x, w, b)
    if hasattr(w, "q") and hasattr(w, "scale"):     # QuantTensor
        out = torch.matmul(x, w.q.to(x.dtype)) * w.scale.to(x.dtype)
    else:
        out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out.float() + b.float()
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_defs(d_model: int, d_ff: int, scale: float = 0.02) -> dict:
    return {"wi_gate": ParamDef((d_model, d_ff), scale=scale),
            "wi_up": ParamDef((d_model, d_ff), scale=scale),
            "wo": ParamDef((d_ff, d_model), scale=scale)}


def mlp_apply(p: dict, x: torch.Tensor, act: str, *, backend=None
              ) -> torch.Tensor:
    g = activation(dense(x, p["wi_gate"], backend=backend), act)
    u = dense(x, p["wi_up"], backend=backend)
    return dense(g * u, p["wo"], backend=backend)


def embed_defs(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), scale=0.02)}


def embed_apply(p: dict, tokens: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


class _HeadProduct(torch.autograd.Function):
    """x2 (M, D) @ w (V, D)^T of low-precision operands summed in fp32 ->
    fp32 (M, V): ``torch.mm``'s ``out_dtype`` form, which has no
    derivative.  The backward rounds the fp32 cotangent to the operands'
    dtype and forms dx = g w and dw = g^T x in it."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gb = g.to(x2.dtype)
        return gb @ w, gb.t() @ x2


def head_apply(w, x: torch.Tensor, cap: float | None = None,
               *, backend=None) -> torch.Tensor:
    """Logits: x (B, S, D) @ w (V, D)^T -> fp32 (B, S, V), optional
    softcap.  The products of compute-dtype operands are summed in fp32
    (the reference's ``preferred_element_type=float32``).  ``backend``
    runs the (B*S, V, D) GEMM through the scheduled kernels against the
    transposed table view (no copy).  On the card, low-precision operands
    give fp32 logits in one call, with no fp32 copy of the (V, D) table.

    A QuantTensor head (an untied lm_head under ``serving_quant_params``)
    is quantized along V, so its scale is per-D and folds into x exactly:
    ``(x * scale) @ q^T``; ``backend`` runs that product as one int8-weight
    GEMM on the transposed payload (K3)."""
    lead, d = x.shape[:-1], x.shape[-1]
    if hasattr(w, "q") and hasattr(w, "scale"):     # QuantTensor head
        x = x * w.scale.to(x.dtype)
        if backend is not None:
            logits = backend.head(x.reshape(-1, d), w)
            return softcap(logits.reshape(*lead, logits.shape[-1]), cap)
        w = w.q
    w = w.to(x.dtype)
    x2 = x.reshape(-1, d)
    if backend is not None:
        logits = backend.matmul(x2, w.t(), out_dtype=torch.float32)
    elif x.is_cuda and x.dtype != torch.float32:
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            logits = _HeadProduct.apply(x2, w)
        else:
            logits = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float().t()
    return softcap(logits.reshape(*lead, logits.shape[-1]), cap)
