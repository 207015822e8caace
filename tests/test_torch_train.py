"""Port parity: the training path (``network.loss_fn`` and its gradients,
``launch.train``'s step and loop, hubert's frames frontend) against
``repro.models.network`` and ``repro.launch.train``.

  * ``loss_fn`` and every gradient leaf of scaled-down qwen2, gemma2,
    mamba2, zamba2, deepseek-v2, llava (patches) and hubert (frames), the
    reference's init weights x4 carried by ``bridge.from_jax_params``,
    plus qwen2 with ``remat=True``: the loss within 1e-5 relative, each
    gradient leaf within 1e-4 of that leaf's max |g| (fp32, one batch of
    the synthetic stream, 2 x 32).
  * ``train()`` against the reference's ``train()`` on scaled-down qwen2
    (fp32, batch 2, seq 32, the reference's initial weights): each of 6
    steps' loss within 1e-5 abs; 12 steps' final loss too, and the
    restart drill of tests/test_system.py (a checkpoint every 4, a
    failure at step 6) reaches it within 1e-5 abs.  One step with
    ``accum=2`` matches the reference's (loss, norm, updated params).
  * hubert-xlarge's config equals the reference's; the train CLI runs
    on ``--device cpu`` (qwen2 and hubert); a ``scheduled`` config is
    refused by ``make_train_step``; the serving engine and
    ``launch/serve.py`` refuse hubert as encoder-only.

The reference's half runs in ONE fresh process, started by the file's
first test and running beside the in-process tests; it writes its
weights, losses and gradients to an ``.npz``.  Its ``train()`` and step
get a one-device mesh with auto axis types (its ``mesh`` parameter):
under its default ``make_local_mesh`` the embedding's ``jnp.take``
raises a ShardingTypeError in this JAX, which ``train()`` retries with
backoff without end (tests/test_system.py's train tests meet it too).
"""

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TT
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw as TA
from repro_torch.runtime.faults import FailureInjector, RestartPolicy
from repro_torch.serving.engine import ContinuousEngine
from _torch_port import WEIGHT_SCALE, _last_json, reference_process

ROOT = Path(__file__).resolve().parents[1]
#: (case, arch, remat): every frontend, MoE, MLA, SSM and hybrid stacks
CASES = [("qwen2", "qwen2_0_5b", False), ("gemma2", "gemma2_9b", False),
         ("mamba2", "mamba2_2_7b", False), ("zamba2", "zamba2_7b", False),
         ("deepseek", "deepseek_v2_236b", False),
         ("llava", "llava_next_mistral_7b", False),
         ("hubert", "hubert_xlarge", False), ("qwen2_remat", "qwen2_0_5b",
                                             True)]
SEQ, BATCH, DATA_SEED = 32, 2, 3
TRAIN = dict(global_batch=2, seq_len=32, log_every=100)

_REFERENCE = f"""
import dataclasses, tempfile
from repro import configs as JC
from repro.data.pipeline import DataConfig, make_batch
from repro.launch import train as JT
from repro.models import network as JN
from repro.optim import adamw as JA
from repro.runtime.faults import RestartPolicy

# a one-device mesh with the default (auto) axis types: under the mesh of
# ``make_local_mesh`` (``jax.make_mesh``, explicit axes in this JAX) the
# reference's ``jnp.take`` of the embedding raises a ShardingTypeError,
# and train() would retry it with backoff
MESH = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))

def named(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {{prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path): np.asarray(leaf)
             for path, leaf in flat}}

arrays, out = {{}}, {{"loss": {{}}}}
for case, arch, remat in {CASES!r}:
    cfg = dataclasses.replace(JC.get(arch).scaled_down(), remat=remat)
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32({WEIGHT_SCALE}),
                          JN.init(cfg, jax.random.PRNGKey(0)))
    batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len={SEQ},
                                       global_batch={BATCH},
                                       seed={DATA_SEED}), 0)
    (loss, _m), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JN.loss_fn(p, cfg, b), has_aux=True))(params, batch)
    out["loss"][case] = float(loss)
    arrays.update(named(case + "/p/", params))
    arrays.update(named(case + "/g/", grads))

# train(): per-step losses, recorded around the reference's own step
cfg = JC.get("qwen2_0_5b").scaled_down()
arrays.update(named("init/", JN.init(cfg, jax.random.PRNGKey(0))))
real = JT.make_train_step
def recording(losses):
    def make(*a, **k):
        step, psh, osh = real(*a, **k)
        def rec(p, o, b):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            return p, o, m
        return rec, psh, osh
    return make
for steps in (6, 12):
    losses = []
    JT.make_train_step = recording(losses)
    JT.train(cfg, JT.TrainConfig(steps=steps, **{TRAIN!r}), mesh=MESH,
             restart_policy=RestartPolicy(max_restarts=0), log=lambda s: None)
    out["train_" + str(steps)] = losses
JT.make_train_step = real

# one step with accum = 2 from the init weights
opt_cfg = JA.AdamWConfig(total_steps=6)
step, _p, _o = real(cfg, opt_cfg, MESH, accum=2, donate=False)
params = JN.init(cfg, jax.random.PRNGKey(0))
batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=4, seed=0), 0)
new, _s, m = step(params, JA.init(opt_cfg, params), batch)
out["accum"] = {{k: float(v) for k, v in m.items()}}
arrays.update(named("accum/", new))

path = tempfile.mkdtemp() + "/ref.npz"
np.savez(path, **arrays)
out["npz"] = path
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_proc():
    """The reference's process, started with the file's first test so
    that it runs beside the in-process tests."""
    yield from reference_process(_REFERENCE, ROOT)


@pytest.fixture(scope="module")
def reference(reference_proc):
    out = _last_json(reference_proc)
    with np.load(out.pop("npz")) as z:
        out["arrays"] = dict(z)
    return out


def _cfg(arch, remat=False):
    return dataclasses.replace(TC.get(arch).scaled_down(), remat=remat)


def _named_tree(arrays, prefix, cfg):
    """The reference's arrays under ``prefix`` as a numpy tree shaped like
    the port's parameters."""
    return tree_map(lambda path, _d: arrays[prefix + "/".join(map(str,
                                                                  path))],
                    TN.param_defs(cfg))


# -- in-process tests first (they run while the reference works) ------------

def test_hubert_config_equals_reference_field_for_field():
    from repro import configs as JC
    j, t = JC.get("hubert_xlarge"), TC.get("hubert_xlarge")
    assert TC.get("hubert-xlarge") == t
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if hasattr(a, "value"):
            a, b = a.value, b.value
        elif isinstance(a, tuple):
            a = tuple(getattr(x, "value", x) for x in a)
            b = tuple(getattr(x, "value", x) for x in b)
        assert a == b, f.name
    defs = TN.param_defs(t)
    assert "embed" not in defs and defs["lm_head"].shape == (504, 1280)
    assert defs["frame_proj"]["w"].shape == (1280, 1280)


def test_remat_gives_the_same_gradients():
    """``torch.utils.checkpoint`` of each group: the loss and every
    gradient equal to those of the plain forward."""
    out = []
    for remat in (False, True):
        cfg = _cfg("mamba2_2_7b", remat)
        params = TN.init(cfg, 0, "cpu")
        ps = TA.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=48,
                                           global_batch=2, seed=1), 0)
        loss, _ = TN.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v
                                           in batch.items()})
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hubert-xlarge"])
def test_train_cli_on_cpu(arch, capsys):
    metrics = TT.main(["--arch", arch, "--scaled-down", "--steps", "2",
                       "--global-batch", "2", "--seq", "32", "--device",
                       "cpu"])
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert "final:" in capsys.readouterr().out


def test_scheduled_backend_refused():
    cfg = dataclasses.replace(_cfg("qwen2_0_5b"), gemm_backend="scheduled")
    with pytest.raises(ValueError, match="cannot differentiate"):
        TT.make_train_step(cfg, TA.AdamWConfig(), device="cpu")


def test_serving_refuses_hubert():
    cfg = _cfg("hubert_xlarge")
    params = TN.init(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        ContinuousEngine(cfg, params, slots=2, max_len=64, device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        TSERVE.main(["--arch", "hubert_xlarge", "--scaled-down", "--device",
                     "cpu"])


def test_eval_step_builds_no_graph():
    cfg = _cfg("qwen2_0_5b")
    params = TN.init(cfg, 0, "cpu")
    batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=2), 0)
    m = TT.make_eval_step(cfg, device="cpu")(params, batch)
    assert m["loss"].grad_fn is None and np.isfinite(float(m["loss"]))
    assert float(m["tokens"]) > 0


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("case,arch,remat", CASES, ids=[c[0] for c in CASES])
def test_loss_and_gradients_match_reference(reference, case, arch, remat):
    cfg = _cfg(arch, remat)
    arrays = reference["arrays"]
    params = bridge.from_jax_params(_named_tree(arrays, case + "/p/", cfg),
                                    cfg, "cpu")
    batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                       global_batch=BATCH, seed=DATA_SEED), 0)
    ps = TA.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _m = TN.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    want = reference["loss"][case]
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    paths = []
    tree_map(lambda path, _d: paths.append(path), TN.param_defs(cfg))
    for path, g in zip(paths, grads):
        w = arrays[case + "/g/" + "/".join(map(str, path))]
        g = np.zeros_like(w) if g is None else g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), \
            path


def test_train_follows_reference_step_by_step(reference, monkeypatch):
    """6 steps from the reference's initial weights, each step's loss
    within 1e-5 abs of the reference's."""
    cfg = _cfg("qwen2_0_5b")
    init = bridge.from_jax_params(_named_tree(reference["arrays"], "init/",
                                              cfg), cfg, "cpu")
    losses = []
    real = TT.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def rec(p, o, b):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            return p, o, m
        return rec
    monkeypatch.setattr(TT, "make_train_step", recording)
    TT.train(cfg, TT.TrainConfig(steps=6, **TRAIN), log=lambda s: None,
             params=init, device="cpu")
    want = reference["train_6"]
    assert len(losses) == len(want) == 6
    assert max(abs(a - b) for a, b in zip(losses, want)) <= 1e-5


def test_restart_drill_reaches_reference_loss(reference):
    """12 steps clean and with a failure at step 6 (a checkpoint every 4):
    both final losses within 1e-5 abs of the reference's clean run."""
    cfg = _cfg("qwen2_0_5b")
    init = bridge.from_jax_params(_named_tree(reference["arrays"], "init/",
                                              cfg), cfg, "cpu")
    base = dict(steps=12, ckpt_every=4, **TRAIN)
    logs = []
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = TT.train(cfg, TT.TrainConfig(ckpt_dir=d1, **base),
                         log=logs.append, params=init, device="cpu")
        faulty = TT.train(cfg, TT.TrainConfig(ckpt_dir=d2, **base),
                          injector=FailureInjector(fail_at_steps=(6,)),
                          restart_policy=RestartPolicy(backoff_s=0.0),
                          log=logs.append, params=init, device="cpu")
    assert "[restore] resumed from step 4" in logs
    want = reference["train_12"][-1]
    assert clean["loss"] == pytest.approx(faulty["loss"], abs=1e-5)
    assert clean["loss"] == pytest.approx(want, abs=1e-5)


def test_accumulated_step_matches_reference(reference):
    cfg = _cfg("qwen2_0_5b")
    arrays = reference["arrays"]
    params = bridge.from_jax_params(_named_tree(arrays, "init/", cfg), cfg,
                                    "cpu")
    opt_cfg = TA.AdamWConfig(total_steps=6)
    step = TT.make_train_step(cfg, opt_cfg, accum=2, device="cpu")
    batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=32,
                                       global_batch=4, seed=0), 0)
    new, _s, m = step(params, TA.init(opt_cfg, params), batch)
    want = reference["accum"]
    assert sorted(m) == sorted(want) == ["grad_norm", "loss", "lr"]
    for k in want:
        assert float(m[k]) == pytest.approx(want[k], rel=1e-5)
    ref_new = _named_tree(arrays, "accum/", cfg)
    for a, b in zip(TA.leaves(new), TA.leaves(ref_new)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
