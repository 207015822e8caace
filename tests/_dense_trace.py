"""The reference's weights and the engine trace of
``tests/test_torch_dense.py``, shared with that file's reference process,
which imports only jax, numpy and the reference (no torch).
"""

import jax
import numpy as np

from repro import configs as JC
from repro.models import network as JN
from _family_scales import family_config

SLOTS, MAX_LEN = 2, 48
#: (prompt length, new tokens): rid 0 (33 + 30) stops at max_len, and its
#: slot then idles past max_len while rid 3 decodes; both waves (plen 33)
#: are cut at max_len.  Two prefill buckets (16 and the terminal 48) and
#: one wave shape keep the reference's compiles few.
TRACE = ((33, 30), (5, 8), (9, 5), (33, 30))


def arch_params(arch: str, scales: tuple[float, float]):
    """(jax config, numpy params): the scaled-down arch (window 16 where
    it has one), the reference's init times (embedding scale, scale of
    every other weight)."""
    jcfg = family_config(JC, arch)
    emb, rest = scales
    raw = JN.init(jcfg, jax.random.PRNGKey(0))
    params = {k: jax.tree.map(lambda a, s=(emb if k == "embed" else rest):
                              np.asarray(a) * np.float32(s), v)
              for k, v in raw.items()}
    return jcfg, params


def trace(vocab: int):
    """[(prompt, new tokens)] of ``TRACE``."""
    rng = np.random.default_rng(0)
    return [(rng.integers(3, vocab, n).astype(np.int32), m)
            for n, m in TRACE]
