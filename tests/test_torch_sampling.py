"""Sampled decoding: ``serving.sampling.sample`` and the engine's use of
it, on the CPU.

The port and the reference draw different random streams, so sampled
tokens are held to their distribution: over n draws a row at temperature
T, the empirical frequencies lie within ``softmax_tv_bound`` -- E[TV] <=
0.5 sum_i sqrt(p_i (1 - p_i) / n) plus 0.02, which a correct sampler
exceeds with probability below exp(-2 n 0.02^2) -- of softmax(logits /
T) in total variation.  The reference's ``_sample_traced`` is held to the
same bound on the same logits.  Greedy rows (T <= 0) are the argmax; a
seed fixes an engine's sampled tokens, and the greedy rows of a mixed
batch equal a greedy-only run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import _sample_traced
from repro_torch.models import bridge
from repro_torch.serving.engine import ContinuousEngine, Request
from repro_torch.serving.sampling import sample, softmax_tv_bound
from _torch_port import reference_params

DRAWS, VOCAB = 10_000, 512
TEMPS = (0.5, 0.8, 1.0, 1.5)


def _logits():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((len(TEMPS), VOCAB)) * 2.0).astype(np.float32)


def _freqs(tokens: np.ndarray) -> np.ndarray:
    """tokens (DRAWS, rows) -> (rows, VOCAB) empirical frequencies."""
    return np.stack([np.bincount(tokens[:, r], minlength=VOCAB) / len(tokens)
                     for r in range(tokens.shape[1])])


def _check(freqs, logits):
    for r, t in enumerate(TEMPS):
        p = torch.softmax(torch.from_numpy(logits[r]).double() / t, -1)
        tv = 0.5 * np.abs(freqs[r] - p.numpy()).sum()
        bound = softmax_tv_bound(p, DRAWS)
        assert tv <= bound, (t, tv, bound)
        assert bound < 0.25                 # the bound says something


def test_sample_within_softmax_bound():
    logits = _logits()
    rows = torch.from_numpy(np.tile(logits, (DRAWS, 1)))
    temps = torch.tensor(TEMPS * DRAWS)
    gen = torch.Generator().manual_seed(0)
    tok = sample(rows, temps, gen).numpy().reshape(DRAWS, len(TEMPS))
    _check(_freqs(tok), logits)


def test_reference_sampler_within_the_same_bound():
    logits = _logits()
    rows = jnp.asarray(np.tile(logits, (DRAWS, 1)))
    temps = jnp.asarray(np.tile(np.float32(TEMPS), DRAWS))
    tok, _key = _sample_traced(jax.random.PRNGKey(0), rows, temps)
    _check(_freqs(np.asarray(tok).reshape(DRAWS, len(TEMPS))), logits)


def test_greedy_rows_are_argmax_and_seed_fixes_the_draw():
    logits = torch.from_numpy(np.tile(_logits(), (64, 1)))
    temps = torch.tensor([0.0, 0.8, -1.0, 1.5] * 64)
    a = sample(logits, temps, torch.Generator().manual_seed(3))
    b = sample(logits, temps, torch.Generator().manual_seed(3))
    c = sample(logits, temps, torch.Generator().manual_seed(4))
    greedy = temps <= 0
    assert a.dtype == torch.int32
    assert torch.equal(a[greedy], logits.argmax(-1).int()[greedy])
    assert torch.equal(a, b) and not torch.equal(a[~greedy], c[~greedy])


@pytest.fixture(scope="module")
def model():
    _jcfg, params, tcfg = reference_params()
    return tcfg, bridge.from_jax_params(params, tcfg, "cpu")


def _requests(vocab, temps):
    rng = np.random.default_rng(5)
    return [Request(i, rng.integers(3, vocab, int(rng.integers(6, 40))
                                    ).astype(np.int32), 10, temperature=t,
                    eos=-1) for i, t in enumerate(temps)]


def _run(model, reqs, seed):
    cfg, params = model
    eng = ContinuousEngine(cfg, params, slots=3, max_len=64, seed=seed,
                           audit=True, device="cpu")
    return {r.rid: r.tokens.tolist()
            for r in eng.run([dataclasses.replace(r) for r in reqs])}


def test_engine_sampling_is_seeded_and_keeps_greedy_rows(model):
    cfg, _ = model
    temps = (0.0, 0.8, 0.0, 1.2, 0.8, 0.0)
    mixed = _requests(cfg.vocab, temps)
    greedy = _run(model, _requests(cfg.vocab, (0.0,) * len(temps)), 0)
    a, b, c = (_run(model, mixed, s) for s in (7, 7, 8))
    assert a == b
    sampled = [i for i, t in enumerate(temps) if t > 0]
    assert any(a[i] != c[i] for i in sampled)
    assert any(a[i] != greedy[i] for i in sampled)
    for i, t in enumerate(temps):
        if t == 0:
            assert a[i] == greedy[i] == c[i]
        assert len(a[i]) == 10
