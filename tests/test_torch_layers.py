"""Port parity: layer primitives of ``repro_torch.models.layers`` against
``repro.models.layers`` on the same numpy inputs (fp32, tolerance 1e-5,
the reference's own paged-attention bound; GEMM-backed layers use the
reference's GEMM bound 1e-4 where the scheduled backend sums by blocks).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops as TOPS
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches_reference(rng):
    x, g = _rand(rng, 3, 5, 64), _rand(rng, 64, scale=0.1)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(g), 1e-6).numpy(),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)), **TOL)


@pytest.mark.parametrize("offset", [0, 7, "vector"])
def test_rope_tables_and_apply_match_reference(rng, offset):
    S, H, D = 5, 3, 32
    x = _rand(rng, 2, S, H, D)
    off = np.array([3, 250], np.int32) if offset == "vector" else offset
    tc, ts = TL.rope_tables(S, D, 1e6, _t(off) if offset == "vector" else off)
    jc, js = JL.rope_tables(S, D, 1e6, jnp.asarray(off))
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), tc, ts).numpy(),
        _np(JL.apply_rope(jnp.asarray(x), jc, js)), **TOL)


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_reference(rng, backend, bias):
    x, w, b = _rand(rng, 2, 3, 96), _rand(rng, 96, 40), _rand(rng, 40)
    be = TOPS.GemmBackend() if backend == "scheduled" else None
    got = TL.dense(_t(x), _t(w), _t(b) if bias else None, backend=be)
    want = JL.dense(jnp.asarray(x), jnp.asarray(w),
                    jnp.asarray(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_activation_and_mlp_match_reference(rng, kind):
    x = _rand(rng, 2, 4, 32)
    np.testing.assert_allclose(TL.activation(_t(x), kind).numpy(),
                               _np(JL.activation(jnp.asarray(x), kind)),
                               **TOL)
    p = {"wi_gate": _rand(rng, 32, 48, scale=0.2),
         "wi_up": _rand(rng, 32, 48, scale=0.2),
         "wo": _rand(rng, 48, 32, scale=0.2)}
    got = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_embed_and_head_match_reference(rng, backend):
    table = _rand(rng, 50, 32)
    tokens = rng.integers(0, 50, (2, 3)).astype(np.int32)
    x = TL.embed_apply({"table": _t(table)}, _t(tokens), torch.float32)
    np.testing.assert_allclose(
        x.numpy(), _np(JL.embed_apply({"table": jnp.asarray(table)},
                                      jnp.asarray(tokens), jnp.float32)),
        **TOL)
    be = TOPS.GemmBackend() if backend == "scheduled" else None
    for cap in (None, 30.0):
        got = TL.head_apply(_t(table), x, cap, backend=be)
        want = JL.head_apply(jnp.asarray(table), jnp.asarray(x.numpy()), cap)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-4)


def test_param_defs_init_scales_and_shapes():
    from repro import configs as JC
    from repro.models import network as JN
    from repro_torch import configs as TC
    from repro_torch.models import network as TN
    cfg = TC.get("qwen2_0_5b").scaled_down()
    params = TN.init(cfg, seed=3, device="cpu")
    jdefs = JN.param_defs(JC.get("qwen2_0_5b").scaled_down())
    table = params["embed"]["table"]
    assert tuple(table.shape) == jdefs["embed"]["table"].shape
    assert abs(float(table.std()) - 0.02) < 2e-3
    attn = params["blocks"][0]["attn"]
    assert tuple(attn["wq"].shape) == jdefs["blocks"][0]["attn"]["wq"].shape
    assert float(attn["bq"].abs().max()) == 0.0
    assert float(params["final_norm"].abs().max()) == 0.0
    again = TN.init(dataclasses.replace(cfg), seed=3, device="cpu")
    assert torch.equal(again["embed"]["table"], table)
