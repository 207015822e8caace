"""Port parity: K1 (paged-decode attention).

The plain version ``repro_torch.kernels.paged_attention.gather_fallback``
is held against the reference's ``gather_fallback`` and its Pallas
``paged_decode_kernel`` in interpret mode, at the reference's tolerance
(1e-5, ``tests/test_paged_attention.py``), with ragged lengths, a
length-0 row and NULL-block table entries past each row's length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPA
from repro.models import attention as JA
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import attention as TA

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(seed=0, B=5, KV=2, G=3, hd=32, nb=20, bs=8, nbs=6,
           lens=(0, 1, 8, 48, 19)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((nb, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((nb, bs, KV, hd)).astype(np.float32)
    bt = rng.integers(1, nb, (B, nbs)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):                      # unallocated tail -> NULL block
        bt[b, -(-int(lens[b]) // bs):] = 0
    return q, k, v, bt, lens


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window,cap", [(None, None), (7, None),
                                        (None, 30.0), (9, 50.0)])
def test_plain_matches_reference_fallback_and_kernel(window, cap):
    q, k, v, bt, lens = _setup()
    got = TPA.gather_fallback(*_torch(q, k, v, bt, lens), scale=0.17,
                              window=window, logit_cap=cap).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, lens)]
    ker = np.asarray(JPA.paged_decode_kernel(
        *jargs, scale=0.17, window=window, logit_cap=cap, interpret=True))
    fb = np.asarray(JPA.gather_fallback(*jargs, scale=0.17, window=window,
                                        logit_cap=cap))
    np.testing.assert_allclose(got, ker, **TOL)
    live = lens > 0      # the reference fallback averages V on len-0 rows
    np.testing.assert_allclose(got[live], fb[live], **TOL)
    assert np.all(got[~live] == 0.0)


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v, bt, lens = _setup(seed=1)
    args = _torch(q, k, v, bt, lens)
    np.testing.assert_array_equal(
        TPA.paged_decode(*args, scale=0.2).numpy(),
        TPA.gather_fallback(*args, scale=0.2).numpy())
    assert TPA.decode_attention(*args, scale=0.2, device="cpu").shape == \
        q.shape


def test_wrapper_rejects_bad_operands():
    q, k, v, bt, lens = _torch(*_setup())
    with pytest.raises(TypeError):
        TPA.paged_decode(q, k, v, bt.long(), lens, scale=0.1)
    with pytest.raises(ValueError):
        TPA.paged_decode(q, k[:, :, :1], v, bt, lens, scale=0.1)
    with pytest.raises(ValueError):
        TPA.paged_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                         bt.to("meta"), lens.to("meta"), scale=0.1)


def test_paged_write_and_flat_index_match_reference():
    rng = np.random.default_rng(2)
    nb, bs, KV, hd, B, S, nbs = 9, 4, 2, 8, 3, 5, 4
    pool = rng.standard_normal((nb, bs, KV, hd)).astype(np.float32)
    upd = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 0, 0]], np.int32)
    pos = np.asarray([0, 6, 14], np.int32)   # row 2 runs past its table
    pos_rows = pos[:, None] + np.arange(S, dtype=np.int32)[None, :]
    np.testing.assert_array_equal(
        TA.paged_flat_index(torch.from_numpy(bt),
                            torch.from_numpy(pos_rows).long(), bs).numpy(),
        np.asarray(JA.paged_flat_index(jnp.asarray(bt),
                                       jnp.asarray(pos_rows), bs)))
    want = np.asarray(JA._paged_write(jnp.asarray(pool), jnp.asarray(upd),
                                      jnp.asarray(pos), jnp.asarray(bt)))
    buf = torch.from_numpy(pool.copy())
    got = TA._paged_write(buf, *_torch(upd, pos, bt))
    assert got is buf                                  # written in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])  # 0 = trash


def test_gather_gemm_shapes_match_reference():
    from repro import configs as JC
    from repro_torch import configs as TC
    for make in (lambda c: c, lambda c: c.scaled_down()):
        jcfg, tcfg = make(JC.get("qwen2_0_5b")), make(TC.get("qwen2_0_5b"))
        assert TPA.gather_gemm_shapes(tcfg, 16) == \
            JPA.gather_gemm_shapes(jcfg, 16)

