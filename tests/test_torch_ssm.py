"""Port parity: the SSD kernel's plain version and the Mamba2 block
(``repro_torch.kernels.ssd``, ``repro_torch.models.ssm``) against the
reference (``repro.kernels.ssd``, ``repro.models.ssm``), on the CPU, with
shared inputs drawn by numpy.

Tolerances: ``ssd_intra`` 2e-4, the reference kernel test's own
(``tests/test_kernels.py``); the chunked scan, the decode step, the conv
and the block 1e-5 (fp32 end to end, the sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as JK
from repro.models import ssm as JS
from repro_torch.kernels import ssd as TK
from repro_torch.models import ssm as TS
from _torch_port import reference_params

KTOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _intra_inputs(G, Q, P, N, seed, rate=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, Q, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (G, Q)).astype(np.float32)
    cums = np.cumsum(-dt * rate, axis=1).astype(np.float32)
    b = rng.standard_normal((G, Q, N)).astype(np.float32)
    c = rng.standard_normal((G, Q, N)).astype(np.float32)
    return x, dt, cums, b, c


@pytest.mark.parametrize("shape", [(4, 32, 16, 8), (6, 64, 32, 16),
                                   (3, 100, 24, 40)], ids=str)
def test_ssd_intra_matches_reference(shape):
    args = _intra_inputs(*shape, seed=sum(shape))
    got = TK.ssd_intra(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(JK.ssd_intra_ref(*args)),
                               **KTOL)
    np.testing.assert_allclose(
        got, np.asarray(JK.ssd_intra(*map(jnp.asarray, args))), **KTOL)


def test_ssd_intra_finite_when_cums_fall_far():
    """cums falling by 150 across the chunk: every masked exponent
    (s < t) overflows exp, and the plain version must stay finite."""
    x, dt, _, b, c = _intra_inputs(2, 64, 16, 8, seed=5)
    cums = np.tile(np.linspace(0.0, -150.0, 64, dtype=np.float32), (2, 1))
    got = TK.ssd_intra_ref(*map(torch.from_numpy, (x, dt, cums, b, c)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(JK.ssd_intra_ref(
        x, dt, cums, b, c)), **KTOL)


def _ssd_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.7, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("S", [64, 50], ids=["chunk-multiple", "ragged"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_ssd_chunked_matches_reference(S, with_h0):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, S, 4, 8, 2, 16, seed=S)
    h0 = h0 if with_h0 else None
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16,
                            None if h0 is None else jnp.asarray(h0))
    ty, th = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 16,
                            None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (2, S, 4, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_ssd_step_matches_reference():
    x, dt, A, Bm, Cm, h = _ssd_inputs(3, 1, 4, 8, 2, 16, seed=11)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h)
    jy, jh = JS.ssd_step(*map(jnp.asarray, args))
    ty, th = TS.ssd_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    B, S, C, K = 4, 7, 12, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, C)).astype(np.float32) \
        if with_state else None
    lens = np.asarray([7, 3, 0, 1], np.int32)
    for seq_len in (None, lens):
        jy, js = JS._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if st is None else jnp.asarray(st),
            None if seq_len is None else jnp.asarray(seq_len))
        ty, ts = TS._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if st is None else torch.from_numpy(st),
            None if seq_len is None else torch.from_numpy(seq_len))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if st is not None:      # a row with seq_len 0 keeps its state
        np.testing.assert_array_equal(ts.numpy()[2], st[2])


@pytest.fixture(scope="module")
def mamba():
    return reference_params(scale=1.0, arch="mamba2_2_7b")


def test_mamba2_block_prefill_then_decode_match_reference(mamba):
    jcfg, params, tcfg = mamba
    p = params["blocks"][0]["mamba"]
    p = {k: v[0] for k, v in p.items()}           # layer 0
    rng = np.random.default_rng(9)
    B, S, d = 3, 40, jcfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in JS.make_ssm_state(jcfg, B, jnp.float32).items()}
    lens = np.asarray([40, 17, 0], np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}

    def both(xin, st, seq_len):
        jo, jst = JS.mamba2_block(jp, jnp.asarray(xin), jcfg,
                                  state={k: jnp.asarray(v)
                                         for k, v in st.items()},
                                  seq_len=jnp.asarray(seq_len))
        to, tst = TS.mamba2_block(tp, torch.from_numpy(xin), tcfg,
                                  state={k: torch.from_numpy(v.copy())
                                         for k, v in st.items()},
                                  seq_len=torch.from_numpy(seq_len))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for k in st:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **TOL)
        return {k: v.numpy() for k, v in tst.items()}

    st = both(x, state, lens)                      # a ragged prefill chunk
    for k in st:                                   # the 0-row is untouched
        np.testing.assert_array_equal(st[k][2], state[k][2])
    both(x[:, :1], st, np.asarray([1, 1, 0], np.int32))      # decode
