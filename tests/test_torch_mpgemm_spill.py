"""Port parity: the spill epilogue (K6's plain version) and the dispatch
telemetry against the reference.

``ops.matmul(epilogue="spill")`` on CPU tensors runs K6's plain version
and a sum; it is held against the reference's ``ops.matmul(epilogue=
"spill")`` in Pallas interpret mode for OS/WS/IS x k_fold on the
reference test's shapes that are not block multiples (1e-4, the bound of
``tests/test_gemm_backend.py``), and against the port's fused path
(1e-5, the bound of the reference's spill-vs-fused test).  The planes
themselves are held to the per-block products in numpy (1e-4: numpy sums
a band in another order), their count to the reference's dispatch model,
``dispatch_plan``'s implementation-independent keys to the reference's on
kernels_bench's sweep, and ``peak_intermediate_bytes`` to the reference's
jaxpr walk.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.kernels_bench import SWEEP_SHAPES, _sweep_blocks
from repro.core.dataflow import Dataflow as JDataflow
from repro.core.scheduler import ScheduleCache as JCache
from repro.kernels import mpgemm as JMP
from repro.kernels import ops as JOPS
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.scheduler import ScheduleCache
from repro_torch.kernels import mpgemm as TMP
from repro_torch.kernels import ops as TOPS

DATAFLOWS = ["OS", "WS", "IS"]
#: keys of dispatch_plan that do not depend on how the kernel is built
PLAN_KEYS = ("dataflow", "epilogue", "k_fold_requested", "k_fold_effective",
             "intermediate_hbm_bytes", "acc_bytes_per_instance")


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("df", DATAFLOWS)
@pytest.mark.parametrize("k_fold", [1, 2, 3])
@pytest.mark.parametrize("shape", [(100, 200, 150), (33, 257, 129)],
                         ids=str)
def test_spill_matmul_matches_reference_nondivisible(df, k_fold, shape):
    M, K, N = shape
    a, b = _operands(M, K, N, sum(shape) + k_fold)
    want = np.asarray(JOPS.matmul(jnp.asarray(a), jnp.asarray(b),
                                  dataflow=JDataflow(df), k_fold=k_fold,
                                  epilogue="spill", interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    spill = TOPS.matmul(ta, tb, dataflow=Dataflow(df), k_fold=k_fold,
                        epilogue="spill")
    fused = TOPS.matmul(ta, tb, dataflow=Dataflow(df), k_fold=k_fold)
    np.testing.assert_allclose(spill.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(spill.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("df", DATAFLOWS)
@pytest.mark.parametrize("k_fold", [1, 2, 3])
def test_spill_planes_match_reference_count(df, k_fold):
    """gk planes under WS/IS whatever the fold, f under OS; each plane the
    product of its K block (WS/IS) or the sum of its band (OS)."""
    M, N, K, bm, bn, bk = 64, 128, 768, 64, 64, 128
    a, b = _operands(M, K, N, 17 + k_fold)
    planes = TMP.mpgemm_spill_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    dataflow=Dataflow(df), bk=bk,
                                    k_fold=k_fold)
    ref = JMP.dispatch_plan(M, N, K, dataflow=JDataflow(df), bm=bm, bn=bn,
                            bk=bk, k_fold=k_fold, epilogue="spill")
    gk, f = K // bk, ref["k_fold_effective"]
    want_planes = gk if df != "OS" else f
    assert planes.shape == (want_planes, M, N)
    if df != "OS" or f > 1:
        assert planes.numel() * 4 == ref["intermediate_hbm_bytes"]
    per = gk // want_planes
    for p in range(want_planes):
        k0, k1 = p * per * bk, (p + 1) * per * bk
        np.testing.assert_allclose(planes[p].numpy(), a[:, k0:k1] @ b[k0:k1],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=lambda s: s[3] + str(
    s[:3]))
def test_dispatch_plan_matches_reference(shape):
    M, N, K, _ = shape
    for df, f, ep in itertools.product(DATAFLOWS, (1, 2, 3),
                                       ("fused", "spill")):
        bm, bn, bk = _sweep_blocks(M, N, K, JDataflow(df))
        kw = dict(bm=bm, bn=bn, bk=bk, k_fold=f, epilogue=ep)
        ours = TMP.dispatch_plan(M, N, K, dataflow=Dataflow(df), **kw)
        ref = JMP.dispatch_plan(M, N, K, dataflow=JDataflow(df), **kw)
        assert {k: ours[k] for k in PLAN_KEYS} == \
            {k: ref[k] for k in PLAN_KEYS}, (df, f, ep)
        if ep == "spill":
            assert ours["out_traffic_bytes"] == ref["out_traffic_bytes"]
        assert ours["grid_steps"] == -(-M // bm) * -(-N // bn) * -(-K // bk)


def test_peak_intermediate_bytes_fused_and_spill():
    """The reference test's gate (``test_fused_path_has_no_partial_plane``)
    at the port's tile: the largest tensor of a fused dispatch is at most
    the output or one block, the spill dispatch materializes its planes --
    the same plane bytes the reference's jaxpr walk finds."""
    M, N, K, bm, bn, bk = 64, 256, 512, 64, 64, 128
    a, b = _operands(M, K, N, 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    cap = max(M * N * 4, bm * bk * 4, bk * bn * 4, bm * bn * 4)
    for df in DATAFLOWS:
        fused = functools.partial(TMP.mpgemm, dataflow=Dataflow(df), bm=bm,
                                  bn=bn, bk=bk, k_fold=2)
        assert TMP.peak_intermediate_bytes(fused, ta, tb) <= cap, df
        spill = functools.partial(fused, epilogue="spill")
        ref = functools.partial(JMP.mpgemm, dataflow=JDataflow(df), bm=bm,
                                bn=128, bk=bk, k_fold=2, epilogue="spill")
        ours = TMP.peak_intermediate_bytes(spill, ta, tb)
        assert ours == JMP.peak_intermediate_bytes(ref, ja, jb), df
    spill = functools.partial(TMP.mpgemm, dataflow=Dataflow.WS, bm=bm,
                              bn=bn, bk=bk, epilogue="spill")
    assert TMP.peak_intermediate_bytes(spill, ta, tb) >= (K // bk) * M * N * 4


def test_os_without_fold_spills_nothing():
    """OS with an effective fold of 1 under ``epilogue="spill"`` takes the
    fused path, as in the reference: no plane, the fused bits."""
    M, N, K = 40, 96, 384                  # gk = 3 at bk = 128: f 2 -> 1
    a, b = (torch.from_numpy(x) for x in _operands(M, K, N, 9))
    kw = dict(dataflow=Dataflow.OS, bm=16, bn=64, bk=128, k_fold=2)
    spill = functools.partial(TMP.mpgemm, epilogue="spill", **kw)
    assert TMP.peak_intermediate_bytes(spill, a, b) <= M * N * 4
    assert torch.equal(spill(a, b), TMP.mpgemm(a, b, **kw))
    plan = TMP.dispatch_plan(M, N, K, bm=16, bn=64, bk=128, k_fold=2,
                             dataflow=Dataflow.OS, epilogue="spill")
    assert plan["intermediate_hbm_bytes"] == 0 and plan["grid"] == (2, 3)


def test_spill_applied_log_records_effective_schedule():
    """Under spill the applied log holds the fold and dataflow that
    executed, as the reference's does."""
    M, N, K = 8, 64, 900
    a, b = _operands(M, K, N, 21)
    ours, ref = ScheduleCache(), JCache()
    got = TOPS.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      schedule=ours, epilogue="spill")
    want = JOPS.matmul(jnp.asarray(a), jnp.asarray(b), schedule=ref,
                       epilogue="spill", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    (key, applied), = ours.applied
    (rkey, rapplied), = ref.applied
    assert key == rkey
    assert (applied.dataflow.value, applied.k_fold) == \
        (rapplied.dataflow.value, rapplied.k_fold)


def test_unknown_epilogue_raises():
    a, b = torch.zeros(8, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="epilogue"):
        TMP.mpgemm(a, b, epilogue="partial")
    with pytest.raises(ValueError, match="epilogue"):
        TOPS.matmul(a, b, epilogue="partial")
    with pytest.raises(ValueError, match="epilogue"):
        TMP.dispatch_plan(8, 64, 64, dataflow=Dataflow.WS, bm=16, bn=64,
                          bk=32, epilogue="partial")
