"""Port parity: AdamW, the int8 gradient compression, the synthetic data
pipeline and the checkpoint manager of ``repro_torch`` against
``repro.optim``, ``repro.data`` and ``repro.checkpoint``, in process.

  * ``adamw.schedule`` at steps 0, mid-warmup, the warmup's end, mid
    decay and the end, and three ``update``s (bf16 and fp32 leaves of
    1, 2 and 3 dims, so the weight-decay mask on the stacked ``ndim``
    shows; with and without a master copy; whole leaves and layer by
    layer) equal the reference's within 1e-6 relative.
  * ``compression._round`` on the reference's uniform draws equals the
    reference's ``compress`` bit for bit; the error feedback adds up to
    the input; the rounding is unbiased over draws.
  * ``make_batch`` is byte-identical for tokens, patches and frames, and
    so is ``host_batch_at``.
  * Checkpoints: a round trip is bit-equal (bf16, fp32 and the int32
    step of an ``AdamWState``) with the reference's leaf names; a
    checkpoint the reference wrote restores into the port bit-equal and
    one the port wrote into the reference; ``keep_last`` and orphaned
    ``.tmp`` directories behave as the reference's.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data import pipeline as JD
from repro.optim import adamw as JA
from repro.optim import compression as JCOMP
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.data import pipeline as TD
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TCOMP


def _tree(seed: int) -> dict:
    """A parameter-like tree: a stacked (G, d) norm, a stacked (G, d, f)
    weight in bf16, a (d,) final norm and a bias tuple."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"ln": rng.standard_normal((2, 6), np.float32),
                       "w": rng.standard_normal((2, 6, 5), np.float32)
                       .astype(ml_dtypes.bfloat16)},
            "final_norm": rng.standard_normal(6, np.float32),
            "bias": (rng.standard_normal(5, np.float32),
                     rng.standard_normal((3, 5), np.float32))}


def _to_torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return np.asarray(t).astype(np.float32) \
        if np.asarray(t).dtype == ml_dtypes.bfloat16 else np.asarray(t)


def _assert_tree_close(got, want, rtol):
    flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(
            1e-30, float(np.abs(w).max())))


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 100, 200, 5100, 10_000])
def test_schedule_matches_reference(step):
    cfg = JA.AdamWConfig()
    want = float(JA.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = TA.schedule(TA.AdamWConfig(),
                      torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("master", [False, True], ids=["no-master",
                                                        "master"])
def test_three_updates_match_reference(master):
    """Three steps from the same params and gradients (scaled so that
    clipping acts on the second): params, m, v, step and the metrics."""
    kw = dict(warmup_steps=2, total_steps=5, lr_peak=1e-2,
              master_copy=master)
    jcfg, tcfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    js, ts = JA.init(jcfg, jp), TA.init(tcfg, tp)
    for i in range(3):
        grads = jax.tree.map(lambda a, i=i: np.asarray(a, np.float32) * (
            0.1 if i != 1 else 10.0), _tree(10 + i))
        grads["blocks"]["w"] = grads["blocks"]["w"].astype(
            ml_dtypes.bfloat16)
        jp, js, jm = JA.update(jcfg, jax.tree.map(jnp.asarray, grads), js,
                               jp)
        tp, ts, tm = TA.update(tcfg, _to_torch(grads), ts, tp)
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        assert tp["blocks"]["w"].dtype == torch.bfloat16
        _assert_tree_close(tp, jp, 1e-6)
        _assert_tree_close(ts.m, js.m, 1e-6)
        _assert_tree_close(ts.v, js.v, 1e-6)
        if master:
            _assert_tree_close(ts.master, js.master, 1e-6)


def test_decay_mask_follows_the_stacked_ndim():
    """Zero gradients: only the decayed leaves move -- the stacked (G, d)
    norm and the (3, 5) bias do, ``final_norm`` (d,) and a (5,) bias do
    not -- as in the reference."""
    cfg = TA.AdamWConfig(warmup_steps=0, total_steps=10, lr_peak=1e-2)
    tp = _to_torch(_tree(1))
    zeros = tree_map(lambda _p, a: torch.zeros_like(a), tp)
    new, _s, _m = TA.update(cfg, zeros, TA.init(cfg, tp),
                            tree_map(lambda _p, a: a.clone(), tp))
    moved = {k: not torch.equal(a, b) for k, a, b in (
        ("ln", new["blocks"]["ln"], tp["blocks"]["ln"]),
        ("final_norm", new["final_norm"], tp["final_norm"]),
        ("bias0", new["bias"][0], tp["bias"][0]),
        ("bias1", new["bias"][1], tp["bias"][1]))}
    assert moved == {"ln": True, "final_norm": False, "bias0": False,
                     "bias1": True}


def test_update_in_place_layer_by_layer(monkeypatch):
    """``update`` writes into the given tensors, and walking stacked
    leaves layer by layer (past the slicing threshold) gives the whole
    leaves' update bit for bit."""
    cfg = TA.AdamWConfig(warmup_steps=1, total_steps=4)
    grads = _to_torch(_tree(3))
    out = []
    for numel in (1 << 24, 8):
        monkeypatch.setattr(TA, "_SLICE_NUMEL", numel)
        tp = _to_torch(_tree(2))
        state = TA.init(cfg, tp)
        w, m = tp["blocks"]["w"], state.m["blocks"]["w"]
        new, new_state, metrics = TA.update(cfg, grads, state, tp)
        assert new["blocks"]["w"] is w and new_state.m["blocks"]["w"] is m
        out.append((TA.leaves((new, new_state.m, new_state.v)), metrics))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1]["grad_norm"], out[1][1]["grad_norm"])


def test_global_norm_and_clip_match_reference():
    g = _tree(4)
    jn = JA.global_norm(jax.tree.map(jnp.asarray, g))
    tn = TA.global_norm(_to_torch(g))
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    jc, _ = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    tc, tgn = TA.clip_by_global_norm(_to_torch(g), 0.5)
    assert float(tgn) == pytest.approx(float(jn), rel=1e-6)
    _assert_tree_close(tc, jc, 1e-6)
    axes = TA.state_logical_axes({"w": ("embed",)})
    assert axes == JA.state_logical_axes({"w": ("embed",)})


# -- compression -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_on_reference_draws_is_reference_compress(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((7, 33)) * 10.0 ** (seed - 1)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    jq, js, je = JCOMP.compress(jnp.asarray(x), key)
    u = np.array(jax.random.uniform(key, x.shape))
    tq, ts, te = TCOMP._round(torch.from_numpy(x), torch.from_numpy(u))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert np.array_equal(te.numpy(), np.asarray(je))
    zq, zs, ze = TCOMP._round(torch.zeros(4), torch.rand(4))
    assert float(zs) == 1.0 and not zq.any() and not ze.any()


def test_error_feedback_adds_up_and_rounding_is_unbiased():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(64, 64, generator=gen)
    # error feedback: what was sent plus what is carried equals the input
    err = torch.zeros_like(x)
    sent = torch.zeros_like(x)
    for _ in range(5):
        q, s, err = TCOMP.compress(x + err, gen)
        sent += TCOMP.decompress(q, s)
    torch.testing.assert_close(sent + err, 5 * x, rtol=0, atol=1e-5)
    # unbiased: the mean of many draws approaches x
    acc = torch.zeros_like(x)
    n = 400
    for _ in range(n):
        q, s, _e = TCOMP.compress(x, gen)
        acc += TCOMP.decompress(q, s)
    scale = float(x.abs().max()) / 127
    assert float((acc / n - x).abs().max()) < 0.2 * scale


def test_tree_helpers():
    grads = {"a": torch.randn(3, 4), "b": (torch.randn(5),)}
    err = TCOMP.init_error(grads)
    q, s, e = TCOMP.compress_tree(grads, err, torch.Generator().manual_seed(0))
    assert q["a"].dtype == torch.int8 and q["b"][0].shape == (5,)
    back = TCOMP.decompress_tree(q, s)
    torch.testing.assert_close(back["a"] + e["a"], grads["a"], rtol=0,
                               atol=1e-6)
    assert TCOMP.wire_bytes(grads) == JCOMP.wire_bytes(
        {"a": np.zeros((3, 4)), "b": (np.zeros(5),)})


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_0_5b", "llava_next_mistral_7b",
                                  "hubert_xlarge"])
def test_make_batch_byte_identical(arch):
    jcfg = JC.get(arch).scaled_down()
    tcfg = TC.get(arch).scaled_down()
    for seq, batch, seed in ((32, 2, 17), (96, 3, 5)):
        jd = JD.DataConfig(vocab=jcfg.vocab, seq_len=seq, global_batch=batch,
                           seed=seed, mean_doc_len=40)
        td = TD.DataConfig(vocab=tcfg.vocab, seq_len=seq, global_batch=batch,
                           seed=seed, mean_doc_len=40)
        for step in (0, 7):
            want = JD.make_batch(jcfg, jd, step)
            got = TD.make_batch(tcfg, td, step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (arch, k)


def test_host_batches_byte_identical():
    jd = JD.DataConfig(vocab=512, seq_len=48, global_batch=4, seed=3)
    td = TD.DataConfig(vocab=512, seq_len=48, global_batch=4, seed=3)
    for host in range(2):
        want = JD.SyntheticLM(jd).host_batch_at(5, host, 2)
        got = TD.SyntheticLM(td).host_batch_at(5, host, 2)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()


# -- checkpoints -------------------------------------------------------------

def _state_pair(seed):
    """(reference tree, port tree): params and an AdamWState after one
    update, the same values in both packages."""
    cfg = JA.AdamWConfig(warmup_steps=1, total_steps=3)
    jp = jax.tree.map(jnp.asarray, _tree(seed))
    jp, js, _ = JA.update(cfg, jax.tree.map(jnp.asarray, _tree(seed + 1)),
                          JA.init(cfg, jp), jp)
    tree = {"params": jp, "opt": js}
    port = jax.tree.map(lambda a: _to_torch(np.asarray(a)), tree)
    port["opt"] = TA.AdamWState(torch.tensor(int(js.step),
                                             dtype=torch.int32),
                                port["opt"].m, port["opt"].v, None)
    return tree, port


def _bits_equal(got, want):
    g = TA.leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert a.dtype == getattr(torch, b.dtype.name)
            assert np.array_equal(a.numpy(), b)


def test_round_trip_bit_equal_with_reference_names(tmp_path):
    _ref, port = _state_pair(0)
    mgr = TManager(str(tmp_path))
    mgr.save(3, port, extra={"step": 3})
    mgr.wait()
    manifest = json.loads((tmp_path / "step_000000003" /
                           "manifest.json").read_text())
    names = [m["name"] for m in manifest["leaves"]]
    assert names[:2] == ["opt/.step", "opt/.m/bias/0"]
    assert "params/blocks/w" in names
    assert {m["dtype"] for m in manifest["leaves"]} >= {"bfloat16",
                                                        "int32"}
    meta = tree_map(lambda _p, a: torch.empty(a.shape, dtype=a.dtype,
                                              device="meta"),
                    {"params": port["params"]})
    meta["opt"] = TA.AdamWState(torch.empty((), dtype=torch.int32,
                                            device="meta"),
                                *(tree_map(lambda _p, a: torch.empty(
                                    a.shape, device="meta"), t)
                                  for t in (port["opt"].m, port["opt"].v)),
                                None)
    got, extra = mgr.restore(meta)
    assert extra == {"step": 3}
    assert got["opt"].step.shape == ()
    for key in ("params", "opt"):
        for a, b in zip(TA.leaves(got[key]), TA.leaves(port[key])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpoint_restores_into_port_and_back(tmp_path):
    ref, port = _state_pair(4)
    JManager(str(tmp_path / "ref")).save(2, ref, blocking=True,
                                         extra={"step": 2})
    got, extra = TManager(str(tmp_path / "ref")).restore(port)
    assert extra == {"step": 2}
    _bits_equal(got, ref)
    TManager(str(tmp_path / "port")).save(2, port, blocking=True)
    back, _ = JManager(str(tmp_path / "port")).restore(ref)
    _bits_equal(port, back)


def test_keep_last_and_orphaned_tmp(tmp_path):
    _ref, port = _state_pair(6)
    mgr = TManager(str(tmp_path), keep_last=2)
    os.makedirs(tmp_path / "step_000000002.tmp")       # a crashed writer
    for step in (1, 2, 3):
        mgr.save(step, port["params"])
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert not (tmp_path / "step_000000002.tmp").exists()
    with pytest.raises(FileNotFoundError):
        TManager(str(tmp_path / "empty")).restore(port)
