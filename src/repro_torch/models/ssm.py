"""Mamba2 / SSD block (state-space duality), chunked p-GEMM formulation
(port of ``repro.models.ssm``).

The chunked algorithm computes the intra-chunk contributions as
(C B^T ⊙ L) X batched matmuls -- the SSD intra-chunk kernel K5
(``kernels.ssd.ssd_intra_chunked``, B and C per group, every operand in
its stored layout) -- and carries the inter-chunk state with a scan over
chunks; the chunk states, the scan and the inter-chunk term are plain
torch einsums per group, as they are plain ``jnp`` in the reference.

Layout follows Mamba2: d_inner = expand * d_model, heads = d_inner /
head_dim, B/C shared per group (n_groups), scalar A per head, conv1d width
d_conv on (x, B, C).  Compute is fp32; recurrent state is stored in the
cache's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as K
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.layers import ParamDef, dense, rms_norm


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, s.d_state, s.n_groups, conv_dim


def mamba2_defs(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, d_state, n_groups, conv_dim = _dims(cfg)
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "in_proj": ParamDef((d, 2 * d_inner + 2 * n_groups * d_state
                             + n_heads)),
        "conv_w": ParamDef((s.d_conv, conv_dim), scale=0.2),
        "conv_b": ParamDef((conv_dim,), init="zeros"),
        "A_log": ParamDef((n_heads,), init="zeros"),
        "D": ParamDef((n_heads,), init="ones"),
        "dt_bias": ParamDef((n_heads,), init="zeros"),
        "norm": ParamDef((d_inner,), init="zeros"),
        "out_proj": ParamDef((d_inner, d)),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, n_heads, d_state, n_groups, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, n_groups * d_state,
                                n_groups * d_state, n_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None,
                 seq_len: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x (B, S, C); w (K, C); returns (y,
    new_state) where the state carries the trailing K-1 inputs.

    ``seq_len`` (B,) counts each row's REAL tokens (trailing pad): the
    carried state is gathered at the row's true tail, ``ctx[b, len : len
    + K-1]``, so pad inputs never leak into decode, and a row with
    ``seq_len == 0`` keeps its incoming state."""
    K = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(ctx[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    y = F.silu(y + b[None, None, :])
    if K <= 1:
        return y, ctx[:, :0, :]
    if seq_len is None:
        return y, ctx[:, -(K - 1):, :]
    idx = (seq_len.long()[:, None]
           + torch.arange(K - 1, device=x.device)[None, :])
    return y, torch.gather(ctx, 1, idx[:, :, None].expand(-1, -1,
                                                         ctx.shape[2]))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in chunked (dual) form, fp32.

    x (B, S, H, P); dt (B, S, H) positive step sizes; A (H,) negative
    decay rates; Bm, Cm (B, S, G, N); h0 (B, H, P, N) or None.  Returns
    (y (B, S, H, P), h_final (B, H, P, N)).

    ``S`` need not be a chunk multiple: the tail is zero-padded with
    dt == 0, which makes those steps exact no-ops (decay exp(0) = 1, no
    input), so ``h_final`` is the state after token S and the pad rows
    of y are dropped."""
    Bb, S_in, H, P = x.shape
    if S_in % chunk:
        pad = chunk - S_in % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    rep = H // G

    # views in the stored layout; B and C stay per group (head h reads
    # group h // rep), so nothing is broadcast to heads
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = Bm.reshape(Bb, nc, chunk, G, N)
    Cc = Cm.reshape(Bb, nc, chunk, G, N)

    dA = dtc * A[None, None, None, :]             # (B, nc, Q, H) negative
    cums = torch.cumsum(dA, dim=2)                # within-chunk cumulative

    # intra-chunk: K5, per group, in the (B, nc, Q, H, .) layout
    y_intra = K.ssd_intra_chunked(xc, dtc, cums, Bc, Cc)

    # chunk-final states: sum_t exp(cums[Q-1] - cums[t]) dt_t B_t x_t
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)      # (B,nc,Q,H)
    w = dtc * decay_to_end
    xw = (xc * w[..., None]).reshape(Bb, nc, chunk, G, rep, P)
    chunk_states = torch.einsum("bctgrp,bctgn->bcgrpn", xw, Bc).reshape(
        Bb, nc, H, P, N)

    # inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(cums[:, :, -1, :])                # (B,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk output: y_t += decay_from_start[t] * C_t . h_prev, added
    # into y_intra in place (one pass, no copy of the permuted product);
    # under autograd out of place, which leaves K5's output to its
    # Function and the backward to the graph
    y_inter = torch.einsum("bcsgn,bcgrpn->bcsgrp", Cc, h_prevs.reshape(
        Bb, nc, G, rep, P, N))
    decay = torch.exp(cums).view(Bb, nc, chunk, G, rep, 1)
    y6 = y_intra.view(Bb, nc, chunk, G, rep, P)
    if y_intra.requires_grad or y_inter.requires_grad:
        y6 = torch.addcmul(y6, y_inter, decay)
    else:
        y6.addcmul_(y_inter, decay)

    y = y6.reshape(Bb, S, H, P)
    return y[:, :S_in], h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step (decode): x (B, H, P); dt (B, H); Bm,
    Cm (B, G, N); h (B, H, P, N)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1)          # (B, H, N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A[None, :])                # (B, H)
    h_new = h * dA[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", x * dt[..., None], Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)
    return y, h_new


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 state: dict | None = None,
                 seq_len: torch.Tensor | None = None, backend=None
                 ) -> tuple[torch.Tensor, dict | None]:
    """Full Mamba2 block.  state: {"conv": (B, K-1, conv_dim), "ssm":
    (B, H, P, N)}, or None for a prefill from scratch.

    ``seq_len`` (B,) enables the masked-update scan for ragged rows (real
    tokens first, trailing pad): pad positions get dt == 0, a per-step
    no-op of the recurrence, so the carried state is exactly the state
    after the last real token, and the conv state is gathered at the
    row's true tail."""
    s: SSMConfig = cfg.ssm
    d_inner, n_heads, d_state, n_groups, conv_dim = _dims(cfg)
    B, S, _ = x.shape
    P = s.head_dim

    zxbcdt = dense(x, p["in_proj"], backend=backend)
    z, xi, Bc, Cc, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        state["conv"] if state is not None else None, seq_len=seq_len)
    xi = conv_out[..., :d_inner]
    Bc = conv_out[..., d_inner:d_inner + n_groups * d_state]
    Cc = conv_out[..., d_inner + n_groups * d_state:]

    A = -torch.exp(p["A_log"].float())
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    if seq_len is not None:
        # masked update: zero step size on pad positions => identity
        valid = (torch.arange(S, device=x.device)[None, :]
                 < seq_len.long()[:, None])
        dtv = dtv * valid[..., None].to(dtv.dtype)

    xh = xi.reshape(B, S, n_heads, P)
    Bm = Bc.reshape(B, S, n_groups, d_state)
    Cm = Cc.reshape(B, S, n_groups, d_state)

    h0 = state["ssm"].float() if state is not None else None
    if S == 1 and state is not None:
        y, h_fin = ssd_step(xh[:, 0].float(), dtv[:, 0], A,
                            Bm[:, 0].float(), Cm[:, 0].float(), h0)
        y = y[:, None]
    else:
        y, h_fin = ssd_chunked(xh.float(), dtv, A, Bm.float(), Cm.float(),
                               min(s.chunk, S), h0)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"], backend=backend)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "ssm": h_fin.to(state["ssm"].dtype)}
    return out, new_state


def make_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    s: SSMConfig = cfg.ssm
    d_inner, n_heads, d_state, n_groups, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, s.head_dim, d_state),
                           dtype=dtype, device=device),
    }
