"""Port parity: the backward of the SSD intra-chunk term (K5-bwd's plain
version ``ssd_intra_chunked_bwd_ref``), the autograd Function around K5
and K5-bwd, and K5-bwd's launch plan.

  * ``ssd_intra_chunked_bwd_ref`` equals torch.autograd of the plain
    forward ``ssd_intra_chunked_ref`` (fp32: the two differ only in the
    order of their sums), and ``jax.vjp`` of the reference's pure-jnp
    ``ssd_intra_ref`` head by head (B and C broadcast to the heads, the
    group's dB and dC summed over them), within 1e-5 of each output's
    max; against autograd also where masked exponents overflow ``exp``.
  * ``ssd_intra_chunked`` builds the Function only where autograd
    records, and its gradients on CPU tensors are the plain backward's;
    ``ssd_chunked``'s output is the same with and without a graph.
  * ``ssd_bwd_plan`` covers every head once with near-equal head blocks,
    fits a CTA's shared memory, and refuses the shapes the kernel does
    not take; the wrapper refuses a device that is neither CPU nor CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as JSSD
from repro_torch.kernels import ssd as TSSD
from repro_torch.models import ssm as TS

#: (B, nc, Q, H, G, P, N): G = 1, grouped heads, a ragged Q, Q = 1
SHAPES = [(2, 2, 16, 4, 1, 8, 6), (1, 3, 24, 6, 2, 5, 7),
          (2, 1, 33, 4, 4, 3, 4), (1, 1, 1, 2, 1, 4, 3)]


def _inputs(B, nc, Q, H, G, P, N, seed, dtype=torch.float32, fall=None):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, nc, Q, H, P, generator=gen, dtype=dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, nc, Q, H, generator=gen, dtype=dtype))
    cums = torch.cumsum(-dt, dim=2)
    if fall is not None:
        cums = torch.linspace(0.0, -fall, Q, dtype=dtype)[
            None, None, :, None].expand(B, nc, Q, H).contiguous()
    b = torch.randn(B, nc, Q, G, N, generator=gen, dtype=dtype)
    c = torch.randn(B, nc, Q, G, N, generator=gen, dtype=dtype)
    dy = torch.randn(B, nc, Q, H, P, generator=gen, dtype=dtype)
    return x, dt, cums, b, c, dy


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        scale = float(w.abs().max()) or 1.0
        assert float((g.double() - w.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize("shape,fall", [(s, None) for s in SHAPES]
                         + [((1, 1, 64, 2, 1, 4, 3), 300.0)], ids=str)
def test_bwd_ref_equals_autograd_of_plain_forward(shape, fall):
    """Also where cums fall by 300 over the chunk: every masked exponent
    overflows ``exp``, and no gradient may be NaN."""
    x, dt, cums, b, c, dy = _inputs(*shape, seed=sum(shape), fall=fall)
    ins = [t.clone().requires_grad_() for t in (x, dt, cums, b, c)]
    want = torch.autograd.grad(TSSD.ssd_intra_chunked_ref(*ins), ins, dy)
    got = TSSD.ssd_intra_chunked_bwd_ref(x, dt, cums, b, c, dy)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shape", [(2, 2, 16, 4, 1, 8, 6),
                                   (1, 2, 24, 6, 2, 5, 7)], ids=["G1", "G2"])
def test_bwd_ref_equals_jax_vjp_of_reference(shape):
    """Head by head against ``jax.vjp`` of the reference's oracle on the
    per-head layout; a group's dB and dC are the sums of its heads'.  (The
    oracle masks after ``exp``: where a masked exponent overflows, its
    gradient is NaN, so no such case is compared here.)"""
    B, nc, Q, H, G, P, N = shape
    x, dt, cums, b, c, dy = _inputs(*shape, seed=7 + Q)
    got = TSSD.ssd_intra_chunked_bwd_ref(x, dt, cums, b, c, dy)
    rep = H // G
    # per head: (B nc H, Q, .) with B and C broadcast to the heads
    def heads(t):
        return np.asarray(t.permute(0, 1, 3, 2, *range(4, t.dim()))
                          .reshape(B * nc * H, Q, *t.shape[4:]))
    bh, ch = (np.asarray(t.repeat_interleave(rep, dim=3).permute(
        0, 1, 3, 2, 4).reshape(B * nc * H, Q, N)) for t in (b, c))
    primals = [jnp.asarray(a) for a in (heads(x), heads(dt), heads(cums),
                                        bh, ch)]
    _y, vjp = jax.vjp(JSSD.ssd_intra_ref, *primals)
    gx, gdt, gcums, gb, gc = (np.asarray(g) for g in vjp(
        jnp.asarray(heads(dy))))

    def back(a):            # (B nc H, Q, .) -> (B, nc, Q, H, .)
        t = torch.from_numpy(np.array(a)).reshape(B, nc, H, Q, *a.shape[2:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))
    gb, gc = (back(g).reshape(B, nc, Q, G, rep, N).sum(dim=4)
              for g in (gb, gc))
    want = (back(gx), back(gdt), back(gcums), gb, gc)
    _close(got, want, 1e-5)


def test_function_only_where_autograd_records():
    x, dt, cums, b, c, dy = _inputs(2, 2, 16, 4, 2, 8, 6, seed=3)
    with torch.no_grad():
        y0 = TSSD.ssd_intra_chunked(x, dt, cums, b, c)
    y1 = TSSD.ssd_intra_chunked(x, dt, cums, b, c)
    assert y0.grad_fn is None and y1.grad_fn is None
    ins = [t.clone().requires_grad_() for t in (x, dt, cums, b, c)]
    y2 = TSSD.ssd_intra_chunked(*ins)
    assert type(y2.grad_fn).__name__ == "SsdIntraChunkedBackward"
    assert torch.equal(y0, y2.detach())
    got = torch.autograd.grad(y2, ins, dy)
    want = TSSD.ssd_intra_chunked_bwd_ref(x, dt, cums, b, c, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_chunked_same_with_and_without_a_graph():
    """The in-place inter-chunk add (serving) and the out-of-place one
    (training) give the same output, and the graph reaches every input."""
    gen = torch.Generator().manual_seed(11)
    Bb, S, H, P, G, N = 2, 40, 4, 8, 2, 6
    x = torch.randn(Bb, S, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(Bb, S, H, generator=gen))
    A = -torch.rand(H, generator=gen) - 0.5
    Bm = torch.randn(Bb, S, G, N, generator=gen)
    Cm = torch.randn(Bb, S, G, N, generator=gen)
    with torch.no_grad():
        y0, h0 = TS.ssd_chunked(x, dt, A, Bm, Cm, 16)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y1, h1 = TS.ssd_chunked(*ins, 16)
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())
    grads = torch.autograd.grad((y1.square().sum() + h1.sum()), ins)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


#: (B, nc, Q, H, G, P): mamba2's and zamba2's training calls, a ragged
#: head block, Q = 32, a ragged Q, one row
PLAN_SHAPES = [(4, 4, 256, 80, 1, 64), (4, 4, 256, 112, 1, 64),
               (8, 4, 256, 26, 2, 64), (8, 1, 32, 80, 1, 64),
               (2, 1, 100, 8, 2, 24), (1, 1, 1, 3, 1, 1)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_bwd_plan_covers_heads(shape):
    B, nc, Q, H, G, P = shape
    plan = TSSD.ssd_bwd_plan(B, nc, Q, H, G, P)
    rep = H // G
    blocks = [min(plan.head_block, rep - i * plan.head_block)
              for i in range(plan.head_blocks)]
    assert sum(blocks) == rep and min(blocks) >= 1
    assert max(blocks) - min(blocks) <= plan.head_block - 1
    assert plan.grid_main == (G * plan.head_blocks, B * nc, -(-Q // 64))
    assert plan.grid_reduce == (G, B * nc, 2 * -(-Q // 64))
    assert plan.smem_bytes <= TSSD.MAX_SMEM_BYTES
    assert plan.wpart_floats == B * nc * G * plan.head_blocks * Q * Q
    if shape[:5] == (4, 4, 256, 80, 1):
        assert plan.head_block == 16        # mamba2's call: 320 CTAs


def test_bwd_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="Q <= 256"):
        TSSD.ssd_bwd_plan(1, 1, 257, 2, 1, 64)
    with pytest.raises(ValueError, match="P <= 64"):
        TSSD.ssd_bwd_plan(1, 1, 64, 2, 1, 65)
    with pytest.raises(ValueError, match="degenerate"):
        TSSD.ssd_bwd_plan(1, 1, 64, 3, 2, 16)
    x, dt, cums, b, c, dy = (t.to("meta") for t in _inputs(
        1, 1, 8, 2, 1, 4, 3, seed=1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        TSSD.ssd_intra_chunked_bwd(x, dt, cums, b, c, dy)
    with pytest.raises(ValueError, match="dy like x"):
        TSSD.ssd_intra_chunked_bwd(*_inputs(1, 1, 8, 2, 1, 4, 3, seed=1)[:5],
                                   torch.zeros(1, 1, 8, 2, 5))
