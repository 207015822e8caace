"""Shared pieces of the ``repro_torch`` parity tests.

``cuda`` is the fixture of the tests marked ``gpu``: it decides at run
time (never at import) whether a card is present and skips otherwise.
``reference_params`` builds weights once with the reference's
``network.init`` and hands the same numpy tree to both packages (qwen2
at x4 by default; mamba2 runs at the init scale, where its greedy
streams already vary).
"""

import dataclasses

import numpy as np
import pytest
import torch

#: weight scale of the engine and network parity runs: at the reference's
#: init scale (0.02) a random model repeats one token per request, which
#: would let a wrong path through; x4 gives varied greedy streams that
#: stay stable under the reference's own run-to-run rounding (x5 does not).
WEIGHT_SCALE = 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def reference_params(scale: float = WEIGHT_SCALE, seed: int = 0,
                     arch: str = "qwen2_0_5b"):
    """(jax config, numpy params, port config) for the scaled-down
    ``arch``, the reference's init times ``scale``."""
    import jax
    from repro import configs as JC
    from repro.models import network as JN
    from repro_torch import configs as TC
    jcfg = JC.get(arch).scaled_down()
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(scale),
                          JN.init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, params, TC.get(arch).scaled_down()


def with_backend(cfg, backend: str):
    return dataclasses.replace(cfg, gemm_backend=backend).validate()


def int8_paths(tree, quant_type) -> set:
    """Paths (dict keys and tuple indices) of the ``quant_type`` leaves of
    a parameter tree (the reference's or the port's QuantTensor)."""
    found = set()

    def walk(t, path):
        if isinstance(t, quant_type):
            found.add(path)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
    walk(tree, ())
    return found


#: the head of every reference script that ``reference_process`` runs:
#: the repo on the path, and the reference engine's and speculative
#: decoder's ``jnp`` with an ``asarray`` that copies, so that each
#: dispatch owns the host arrays it reads.  The reference changes them in
#: place while an asynchronous dispatch may still read them, and its
#: greedy tokens then move from run to run (ROADMAP Queue 3, "A fault of
#: the reference that the port does not share").
REFERENCE_HEAD = """
import dataclasses, json, sys, time, types
import jax, jax.numpy as jnp
import numpy as np
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import repro.serving.engine as E
import repro.serving.spec as S
shim = types.SimpleNamespace(**{{k: getattr(jnp, k) for k in dir(jnp)
                                 if not k.startswith("__")}})
shim.asarray = lambda x, *a, **k: jnp.array(
    np.array(x) if isinstance(x, np.ndarray) else x, *a, **k)
E.jnp = S.jnp = shim
"""


def reference_process(code: str, root, *, one_thread: bool = True):
    """Generator of a module fixture: the reference's script ``code``,
    after ``REFERENCE_HEAD``, in a fresh process (the reference's XLA:CPU
    rounding depends on what ran before it in a process), running beside
    the file's in-process tests, which take half the torch threads
    meanwhile (``tests/test_torch_dense.py``).  ``one_thread`` puts XLA's
    CPU matmuls on one thread: multi-threaded, their sums split by thread
    and an int8 run's tokens move under load
    (``tests/test_torch_quant_engine.py``).  Yields the process."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(root)
    script = REFERENCE_HEAD.format(root=str(root), src=str(root / "src"),
                                   tests=str(root / "tests")) + code
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if one_thread:
        env["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
            " --xla_cpu_multi_thread_eigen=false"
            " intra_op_parallelism_threads=1")).strip()
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=root, env=env)
    try:
        yield proc
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _last_json(proc):
    import json
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def run_reference(code: str, root, **kw):
    """``reference_process`` waited for: the JSON of its last line."""
    gen = reference_process(code, root, **kw)
    try:
        return _last_json(next(gen))
    finally:
        gen.close()


def reference_results(proc) -> dict:
    """The JSON of the reference process's last line, each run's
    ``tokens`` keyed by int rid."""
    runs = _last_json(proc)
    for run in runs.values():
        run["tokens"] = {int(k): v for k, v in run["tokens"].items()}
    return runs
