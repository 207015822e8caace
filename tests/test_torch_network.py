"""Port parity: the paged serving functions of ``repro_torch.models
.network`` against ``repro.models.network`` with the same weights (the
reference's ``network.init`` through ``bridge.from_jax_params``).

A prefill chunk followed by a decode step over the same block tables
must give fp32 logits within 1e-4 (the reference's GEMM bound: logits
sum products over d_model) with identical argmax, identical cursors and
pools within the same bound -- under both GEMM backends.  The cache-tree
utilities must match the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import network as JN
from repro_torch.models import bridge
from repro_torch.models import network as TN
from _torch_port import reference_params, with_backend

TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, NB, BS = 3, 24, 8


@pytest.fixture(scope="module")
def ref():
    return reference_params()


def _np(x):
    return np.asarray(x, np.float32)


def _jax_caches(jcfg):
    return JN.expand_cache_pos(JN.init_paged_caches(jcfg, SLOTS, NB, BS),
                               SLOTS)


def _torch_caches(tcfg):
    return TN.expand_cache_pos(
        TN.init_paged_caches(tcfg, SLOTS, NB, BS, device="cpu"), SLOTS)


def test_bridge_maps_every_leaf(ref):
    jcfg, params, tcfg = ref
    tp = bridge.from_jax_params(params, tcfg, device="cpu")
    flat_ref = jax.tree_util.tree_leaves(params)
    flat_port = []
    from repro_torch.models.layers import tree_map
    tree_map(lambda _p, a: flat_port.append(a), tp)
    assert len(flat_port) == len(flat_ref)
    np.testing.assert_array_equal(tp["blocks"][0]["attn"]["wq"].numpy(),
                                  params["blocks"][0]["attn"]["wq"])
    extra = dict(params, lm_head=params["embed"]["table"])
    with pytest.raises(KeyError, match="no port counterpart"):
        bridge.from_jax_params(extra, tcfg, device="cpu")
    short = dict(params, final_norm=params["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        bridge.from_jax_params(short, tcfg, device="cpu")
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(KeyError):
        bridge.from_jax_params(missing, tcfg, device="cpu")


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_prefill_chunk_then_decode_match_reference(ref, backend):
    jcfg, params, tcfg = ref
    tcfg = with_backend(tcfg, backend)
    tp = bridge.from_jax_params(params, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    nbs = 6
    tables = np.zeros((SLOTS, nbs), np.int32)
    tables[0, :4] = [3, 7, 1, 12]
    tables[1, :3] = [5, 2, 9]          # slot 2 rides along empty (NULL)
    L = 10
    toks = rng.integers(3, jcfg.vocab, (SLOTS, L)).astype(np.int32)
    lens = np.asarray([10, 6, 0], np.int32)
    last = np.maximum(lens - 1, 0)
    ids = np.arange(SLOTS, dtype=np.int32)

    jc = _jax_caches(jcfg)
    jlog, jc = JN.prefill_paged_chunk(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(toks), jc,
        jnp.asarray(ids), jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(last))
    tc = _torch_caches(tcfg)
    t = torch.from_numpy
    tlog, tc = TN.prefill_paged_chunk(tp, tcfg, t(toks), tc, t(ids),
                                      t(tables), t(lens), t(last))
    live = lens > 0
    np.testing.assert_allclose(tlog.numpy()[live], _np(jlog)[live], **TOL)
    np.testing.assert_array_equal(tlog.numpy()[live].argmax(-1),
                                  _np(jlog)[live].argmax(-1))
    jg, tg = jc["groups"][0], tc["groups"][0]
    np.testing.assert_array_equal(tg["pos"].numpy(), np.asarray(jg["pos"]))
    np.testing.assert_allclose(tg["k"].numpy()[:, 1:], _np(jg["k"])[:, 1:],
                               **TOL)

    # one decode step: slots 0 and 1 decode, slot 2 stays masked
    pos = np.asarray(jg["pos"])[0].astype(np.int32)
    adv = np.asarray([1, 1, 0], np.int32)
    dtok = rng.integers(3, jcfg.vocab, (SLOTS, 1)).astype(np.int32)
    jlog, jc = JN.decode_step(jax.tree.map(jnp.asarray, params), jcfg,
                              jnp.asarray(dtok), jc, jnp.asarray(pos),
                              block_table=jnp.asarray(tables),
                              pos_advance=jnp.asarray(adv))
    tlog, tc = TN.decode_step(tp, tcfg, t(dtok), tc, t(pos), t(tables),
                              t(adv))
    live = adv > 0
    np.testing.assert_allclose(tlog.numpy()[live], _np(jlog)[live], **TOL)
    np.testing.assert_array_equal(tlog.numpy()[live].argmax(-1),
                                  _np(jlog)[live].argmax(-1))
    np.testing.assert_array_equal(tc["groups"][0]["pos"].numpy(),
                                  np.asarray(jc["groups"][0]["pos"]))
    np.testing.assert_allclose(tc["groups"][0]["v"].numpy()[:, 1:],
                               _np(jc["groups"][0]["v"])[:, 1:], **TOL)


def test_cache_utilities_match_reference(ref):
    jcfg, _params, tcfg = ref
    rng = np.random.default_rng(6)
    jc, tc = _jax_caches(jcfg), _torch_caches(tcfg)
    kv = rng.standard_normal(tuple(tc["groups"][0]["k"].shape)
                             ).astype(np.float32)
    pos = rng.integers(0, 40, tuple(tc["groups"][0]["pos"].shape)
                       ).astype(np.int32)
    jc = {"groups": ({"k": jnp.asarray(kv), "v": jnp.asarray(kv * 2),
                      "pos": jnp.asarray(pos)},)}
    tc = {"groups": ({"k": torch.from_numpy(kv.copy()),
                      "v": torch.from_numpy(kv * 2),
                      "pos": torch.from_numpy(pos.copy())},)}

    def same(t, j):
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(t["groups"][0][key].numpy(),
                                          np.asarray(j["groups"][0][key]))

    src, dst = np.asarray([3, 5], np.int32), np.asarray([9, 3], np.int32)
    jc = JN.copy_paged_blocks(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = TN.copy_paged_blocks(tc, torch.from_numpy(src),
                              torch.from_numpy(dst))
    same(tc, jc)
    jc, tc = JN.reset_slot_state(jc, 1, 16), TN.reset_slot_state(tc, 1, 16)
    same(tc, jc)
    new = np.asarray([4, 8, 12], np.int32)
    jc = JN.set_slot_pos(jc, jnp.asarray(new))
    tc = TN.set_slot_pos(tc, torch.from_numpy(new))
    same(tc, jc)
    ids = np.asarray([2, 0], np.int32)
    jv = JN.gather_slot_view(jc, jnp.asarray(ids))
    tv = TN.gather_slot_view(tc, torch.from_numpy(ids))
    same(tv, jv)
    jv = JN.set_slot_pos(jv, jnp.asarray([30, 31], jnp.int32))
    tv = TN.set_slot_pos(tv, torch.tensor([30, 31], dtype=torch.int32))
    same(TN.scatter_slot_view(tc, tv, torch.from_numpy(ids)),
         JN.scatter_slot_view(jc, jv, jnp.asarray(ids)))
    assert TN.kv_cache_bytes(tc) == JN.kv_cache_bytes(jc)
