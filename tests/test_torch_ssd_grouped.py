"""K5's grouped entry (``repro_torch.kernels.ssd.ssd_intra_chunked``) on
the CPU: its plain version against the reference's pure-jnp
``repro.kernels.ssd.ssd_intra_ref`` on the broadcast heads-first layout,
the launch plan ``ssd_plan`` as a pure function, and ``ssd_chunked``
free of broadcasts.  Inputs from numpy with a seed.

Tolerance 2e-4, the reference kernel test's own (``tests/test_kernels.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels import ssd as JK
from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import ssd as TK
from repro_torch.models import ssm as TS

KTOL = dict(rtol=2e-4, atol=2e-4)


def _grouped_inputs(B, nc, Q, H, G, P, N, seed, fall=None, pad=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, Q, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, nc, Q, H)).astype(np.float32)
    if pad:
        dt[:, :, Q - pad:] = 0.0
    cums = np.cumsum(-dt * 0.5, axis=2).astype(np.float32)
    if fall is not None:
        cums = np.broadcast_to(np.linspace(0.0, -fall, Q, dtype=np.float32)
                               [None, None, :, None], cums.shape).copy()
    b = rng.standard_normal((B, nc, Q, G, N)).astype(np.float32)
    c = rng.standard_normal((B, nc, Q, G, N)).astype(np.float32)
    return x, dt, cums, b, c


def _reference(x, dt, cums, b, c):
    """The reference's per-head oracle on the broadcast heads-first layout
    (what the parent's ``ssd_chunked`` built), back in (B, nc, Q, H, P)."""
    B, nc, Q, H, P = x.shape
    rep = H // b.shape[3]

    def heads_first(t):
        t = np.moveaxis(t, 3, 2)
        return t.reshape(B * nc * H, Q, *t.shape[4:])

    bh, ch = (np.repeat(t, rep, axis=3) for t in (b, c))
    y = np.asarray(JK.ssd_intra_ref(*(jnp.asarray(heads_first(t))
                                      for t in (x, dt, cums, bh, ch))))
    return np.moveaxis(y.reshape(B, nc, H, Q, P), 2, 3)


@pytest.mark.parametrize("case", [
    dict(B=2, nc=1, Q=32, H=4, G=1, P=16, N=8),
    dict(B=1, nc=2, Q=32, H=4, G=2, P=16, N=8),
    dict(B=2, nc=1, Q=50, H=4, G=2, P=24, N=40),
    dict(B=1, nc=1, Q=64, H=4, G=1, P=16, N=8, fall=150.0),
    dict(B=1, nc=2, Q=64, H=4, G=2, P=16, N=8, pad=20),
], ids=["G1", "G2", "ragged-Q50", "cums-fall-150", "dt0-pad-tail"])
def test_grouped_plain_matches_reference(case):
    shape = {k: v for k, v in case.items() if k not in ("fall", "pad")}
    args = _grouped_inputs(**shape, seed=sum(shape.values()),
                           fall=case.get("fall"), pad=case.get("pad", 0))
    got = TK.ssd_intra_chunked(*map(torch.from_numpy, args))
    assert got.shape == args[0].shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _reference(*args), **KTOL)
    if case.get("pad"):       # dt = 0 rows add nothing to later rows
        x, dt, cums, b, c = args
        pad = case["pad"]
        head = TK.ssd_intra_chunked_ref(*(torch.from_numpy(np.ascontiguousarray(
            t[:, :, :-pad])) for t in args))
        np.testing.assert_allclose(got.numpy()[:, :, :-pad], head.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_grouped_plain_reads_strided_views():
    """x, B and C as views of wider tensors (the conv output's slices),
    dt with a head stride: the same result as contiguous copies."""
    x, dt, cums, b, c = _grouped_inputs(2, 2, 16, 4, 2, 8, 8, seed=3)
    wide = np.concatenate([x.reshape(2, 2, 16, 32), b.reshape(2, 2, 16, 16),
                           c.reshape(2, 2, 16, 16)], axis=-1)
    wt = torch.from_numpy(wide)
    xv = wt[..., :32].reshape(2, 2, 16, 4, 8)
    bv = wt[..., 32:48].reshape(2, 2, 16, 2, 8)
    cv = wt[..., 48:].reshape(2, 2, 16, 2, 8)
    assert not xv.is_contiguous()
    dtv = torch.from_numpy(np.ascontiguousarray(np.moveaxis(dt, 3, 0))
                           ).movedim(0, 3)
    got = TK.ssd_intra_chunked(xv, dtv, torch.from_numpy(cums), bv, cv)
    want = TK.ssd_intra_chunked(*map(torch.from_numpy, (x, dt, cums, b, c)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_per_head_entry_is_the_grouped_case():
    """``ssd_intra`` on (G', Q, .) equals the grouped entry with batch G'
    and one head of one group."""
    rng = np.random.default_rng(8)
    G_, Q, P, N = 3, 40, 16, 8
    dt = rng.uniform(0.01, 0.2, (G_, Q)).astype(np.float32)
    args = [rng.standard_normal((G_, Q, P)).astype(np.float32), dt,
            np.cumsum(-dt, axis=1).astype(np.float32),
            rng.standard_normal((G_, Q, N)).astype(np.float32),
            rng.standard_normal((G_, Q, N)).astype(np.float32)]
    ts = [torch.from_numpy(a) for a in args]
    got = TK.ssd_intra_chunked(*(t[:, None, :, None] for t in ts))[:, 0, :, 0]
    torch.testing.assert_close(got, TK.ssd_intra(*ts), **KTOL)


def test_grouped_entry_refuses_what_the_kernel_does_not_take():
    x, dt, cums, b, c = map(torch.from_numpy,
                            _grouped_inputs(1, 1, 8, 4, 2, 4, 4, seed=1))
    with pytest.raises(ValueError, match="G dividing H"):
        TK.ssd_intra_chunked(x, dt, cums, b[..., :1, :].repeat(1, 1, 1, 3, 1),
                             c[..., :1, :].repeat(1, 1, 1, 3, 1))
    with pytest.raises(ValueError):
        TK.ssd_intra_chunked(x, dt[:, :, :4], cums, b, c)
    with pytest.raises(TypeError):
        TK.ssd_intra_chunked(x.double(), dt, cums, b, c)
    before = TK.launches.count
    with pytest.raises(ValueError, match="cuda or cpu"):
        TK.ssd_intra_chunked(*(t.to("meta") for t in (x, dt, cums, b, c)))
    with pytest.raises(ValueError, match="cuda or cpu"):      # per-head
        TK.ssd_intra(*(t[:, 0, :, 0].to("meta")
                       for t in (x, dt, cums, b, c)))
    assert TK.launches.count == before


def _covered(plan, batch_chunks, Q, H):
    seen = {}
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            for z in range(plan.grid[2]):
                bc, s0, heads = plan.cta(x, y, z)
                assert len(heads) >= 1
                for h in heads:
                    key = (bc, s0, h)
                    seen[key] = seen.get(key, 0) + 1
    want = {(bc, s0, h) for bc in range(batch_chunks)
            for s0 in range(0, Q, TK.S_BLOCK) for h in range(H)}
    return seen, want


@pytest.mark.parametrize("shape", [
    (8, 1, 256, 80, 1),       # mamba2-2.7b's chunk step
    (8, 1, 32, 80, 1),        # the engine's default chunk
    (640, 1, 256, 1, 1),      # the per-head layout (ssd_intra)
    (2, 2, 32, 4, 2),         # scaled-down, two groups
    (1, 3, 50, 20, 2),        # ragged Q, 10 heads a group
    (1, 1, 100, 3, 1),        # heads not a multiple of any block
], ids=str)
def test_ssd_plan_covers_every_row_and_head_once(shape):
    batch, nc, Q, H, G = shape
    plan = TK.ssd_plan(batch, nc, Q, H, G)
    seen, want = _covered(plan, batch * nc, Q, H)
    assert set(seen) == want
    assert all(n == 1 for n in seen.values())
    # a head block lies in one group
    for x in range(plan.grid[0]):
        heads = plan.cta(x, 0, 0)[2]
        assert len({h // (H // G) for h in heads}) == 1
    # heaviest s-blocks first: z = 0 is the last s-block
    s_first = [plan.cta(0, 0, z)[1] for z in range(plan.grid[2])]
    assert s_first == sorted(s_first, reverse=True)
    assert plan.smem_bytes <= TK.MAX_SMEM_BYTES


def test_ssd_plan_at_full_width_fills_the_card():
    """mamba2-2.7b (8 chunks of 256, 80 heads, one group): 8-head blocks,
    320 CTAs, at least two an SM; 16-head blocks would leave 160."""
    plan = TK.ssd_plan(8, 1, 256, 80, 1)
    assert plan.head_block == 8
    assert plan.grid == (10, 8, 4)
    assert plan.ctas >= 2 * NUM_SMS
    assert TK.ssd_plan(8, 1, 256, 160, 1).head_block == 16
    # fewer chunks: smaller blocks, still the most CTAs a block allows
    small = TK.ssd_plan(1, 1, 256, 80, 1)
    assert small.head_block == 1 and small.ctas == 320
    # never more heads a block than a group has
    assert TK.ssd_plan(8, 1, 4096, 4, 2).head_block == 2
    assert math.ceil(80 / 8) == plan.head_blocks


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def test_ssd_chunked_broadcasts_nothing(monkeypatch):
    """The chunked scan reads B and C per group: no repeat_interleave, no
    contiguous copy, and K5's grouped entry called once."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4, 8)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (2, 64, 4)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (4,)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((2, 64, 2, 16))
                               .astype(np.float32)) for _ in range(2))
    calls = []
    real = TK.ssd_intra_chunked
    monkeypatch.setattr(TK, "ssd_intra_chunked",
                        lambda *a: calls.append(a) or real(*a))
    with _Calls() as mode:
        TS.ssd_chunked(x, dt, A, Bm, Cm, 16)
    assert len(calls) == 1
    assert calls[0][3].shape == (2, 4, 16, 2, 16)      # per group
    assert "repeat_interleave" not in mode.names
    assert "contiguous" not in mode.names
