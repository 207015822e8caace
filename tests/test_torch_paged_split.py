"""K1's split-KV grid on the CPU: ``split_plan`` and the plain mirror of
the kernel's split-and-combine arithmetic.

``split_decode_plain`` repeats what ``csrc/paged_decode.cu`` does -- each
split folds its live blocks into (m, l, acc) in fp32, the live splits are
combined in order -- and is held against ``gather_fallback`` at the
reference's paged-attention tolerance (1e-5, ``tests/test_paged_attention.py``)
for fp32 and int8 pools, several split sizes, lengths 0, 1, a split
boundary +-1 and the full table, a window that empties the leading
splits, and a softcap.  Two cases are also held against the reference's
Pallas ``paged_decode_kernel`` in interpret mode.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPA
from repro_torch.kernels import paged_attention as TPA

TOL = dict(rtol=1e-5, atol=1e-5)
B, KV, G, HD, BS, NBS = 6, 2, 3, 16, 4, 8


def _lengths(bps):
    edge = bps * BS
    return (0, 1, edge - 1, edge, edge + 1, NBS * BS)


def _setup(lens, quant, seed=0):
    rng = np.random.default_rng(seed)
    nb = 1 + B * NBS
    q = rng.standard_normal((B, KV, G, HD)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (nb, BS, KV, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (nb, BS, KV, HD)).astype(np.int8)
        ks = (0.001 + 0.03 * rng.random((nb, BS, KV))).astype(np.float32)
        vs = (0.001 + 0.03 * rng.random((nb, BS, KV))).astype(np.float32)
    else:
        k = rng.standard_normal((nb, BS, KV, HD)).astype(np.float32)
        v = rng.standard_normal((nb, BS, KV, HD)).astype(np.float32)
        ks = vs = None
    bt = (1 + rng.permutation(nb - 1)[:B * NBS]).reshape(B, NBS)
    bt = bt.astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):                      # NULL block past the length
        bt[b, -(-int(lens[b]) // BS):] = 0
    return q, k, v, bt, lens, ks, vs


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("B_,KV_,nbs,bs", [
    (8, 2, 64, 16), (1, 2, 64, 16), (8, 20, 64, 16), (1, 1, 1, 16),
    (3, 2, 7, 8), (1, 1, 4096, 16), (64, 8, 33, 4), (2, 1, 5, 1),
    (512, 2, 64, 16)])
def test_split_plan_covers_the_table(B_, KV_, nbs, bs):
    bps, n = TPA.split_plan(B_, KV_, nbs, bs)
    assert isinstance(bps, int) and isinstance(n, int)
    assert bps >= 1 and n * bps >= nbs and (n - 1) * bps < nbs
    assert bps * bs >= min(TPA.MIN_SPLIT_POSITIONS, nbs * bs)
    assert n * B_ * KV_ <= max(2 * TPA.SMS + B_ * KV_, B_ * KV_)


def test_split_plan_reads_shapes_only():
    assert list(inspect.signature(TPA.split_plan).parameters) == \
        ["B", "KV", "nbs", "bs"]
    assert TPA.split_plan(8, 2, 64, 16) == (4, 16)   # qwen2: 256 CTAs
    assert TPA.split_plan(8, 2, 1, 16) == (1, 1)     # one block: S = 1


@pytest.mark.parametrize("window,cap", [(None, None), (5, None),
                                        (None, 2.0), (9, 2.0)])
@pytest.mark.parametrize("bps", [1, 2, 3, NBS])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_split_mirror_matches_gather(quant, bps, window, cap):
    q, k, v, bt, lens, ks, vs = _setup(_lengths(bps), quant, seed=bps)
    kw = dict(scale=0.3, window=window, logit_cap=cap, k_scale=_torch(ks),
              v_scale=_torch(vs))
    args = [_torch(a) for a in (q, k, v, bt, lens)]
    got = TPA.split_decode_plain(*args, blocks_per_split=bps, **kw)
    want = TPA.gather_fallback(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert not got[0].any()                 # length 0: zeros


def test_window_empties_leading_splits():
    """A window shorter than a split: the rows' leading splits hold no
    valid position and drop out of the combine."""
    lens = (30, 29, 17, 32, 9, 4)
    q, k, v, bt, lens, _, _ = _setup(lens, False, seed=7)
    args = [_torch(a) for a in (q, k, v, bt, lens)]
    for bps in (1, 2):
        got = TPA.split_decode_plain(*args, scale=0.3, window=3,
                                     blocks_per_split=bps)
        want = TPA.gather_fallback(*args, scale=0.3, window=3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("quant,bps,window,cap", [
    (False, 2, 9, 2.0), (True, 3, None, None)], ids=["fp32", "int8"])
def test_split_mirror_matches_reference_kernel(quant, bps, window, cap):
    q, k, v, bt, lens, ks, vs = _setup(_lengths(bps), quant, seed=11)
    got = TPA.split_decode_plain(
        *[_torch(a) for a in (q, k, v, bt, lens)], scale=0.3,
        blocks_per_split=bps, window=window, logit_cap=cap,
        k_scale=_torch(ks), v_scale=_torch(vs)).numpy()
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    want = np.asarray(JPA.paged_decode_kernel(
        *[jnp.asarray(a) for a in (q, k, v, bt, lens)], scale=0.3,
        window=window, logit_cap=cap, interpret=True, **jkw))
    np.testing.assert_allclose(got, want, **TOL)
