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
