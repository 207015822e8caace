"""Port parity: K2 (the dataflow-scheduled GEMM) and the schedule layer.

The plain version, reached through ``repro_torch.kernels.ops.matmul`` on
CPU tensors, is held against the reference's ``ops.matmul`` in Pallas
interpret mode for OS/WS/IS x k_fold on shapes that are not block
multiples (1e-4, the reference's ``tests/test_gemm_backend.py`` bound).
The port's ScheduleCache must make the reference's (dataflow, k_fold)
choice on a grid of shapes, and the applied log must record the fold
that executed.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import Dataflow as JDataflow
from repro.core.scheduler import ScheduleCache as JCache
from repro.kernels import mpgemm as JMP
from repro.kernels import ops as JOPS
from repro_torch.core import tiling
from repro_torch.core.dataflow import ArrayShape, Dataflow, Direction
from repro_torch.core.scheduler import CachedChoice, ScheduleCache
from repro_torch.kernels import mpgemm as TMP
from repro_torch.kernels import ops as TOPS


@pytest.mark.parametrize("df", ["OS", "WS", "IS"])
@pytest.mark.parametrize("k_fold", [1, 2, 3])
def test_plain_matches_reference_nondivisible(df, k_fold):
    M, K, N = 33, 257, 129
    rng = np.random.default_rng(M + K + N + k_fold)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want = np.asarray(JOPS.matmul(jnp.asarray(a), jnp.asarray(b),
                                  dataflow=JDataflow(df), k_fold=k_fold,
                                  interpret=True))
    got = TOPS.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      dataflow=Dataflow(df), k_fold=k_fold)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_bf16_and_transposed_operand():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((8, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((70, 96)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        got = TMP.mpgemm(a.to(dt), w.to(dt).t(), dataflow=Dataflow.IS,
                         bm=16, bn=64, bk=32, out_dtype=torch.float32)
        want = a.to(dt).float() @ w.to(dt).float().t()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_effective_fold_matches_reference():
    for K, bk, f in itertools.product((100, 384, 512, 896, 4864),
                                      (32, 64, 128), (1, 2, 3, 4, 8)):
        assert TMP.effective_fold(K, bk, f) == JMP.effective_fold(K, bk, f)


def test_schedule_choices_match_reference():
    """Same (dataflow, k_fold, array, direction) as the reference's cache
    on the serving shapes of the full and the scaled-down config."""
    ours, ref = ScheduleCache(), JCache()
    Ms = (1, 2, 8, 64, 256)
    NKs = ((896, 896), (128, 896), (4864, 896), (896, 4864),
           (151936, 896), (7, 16), (128, 128), (64, 128), (256, 128),
           (128, 256), (512, 128), (100, 1000))
    for M, (N, K), prec in itertools.product(Ms, NKs, ("BP16", "FP32")):
        a, b = ours.resolve(M, N, K, prec), ref.resolve(M, N, K, prec)
        assert (a.dataflow.value, a.k_fold, a.direction.value,
                (a.array.rows, a.array.cols)) == \
            (b.dataflow.value, b.k_fold, b.direction.value,
             (b.array.rows, b.array.cols)), (M, N, K, prec)
        assert a.cycles == b.cycles and a.traffic_bytes == b.traffic_bytes
        assert ours.realizable_k_folds(K) == ref.realizable_k_folds(K)


def test_applied_log_records_effective_fold():
    sc = ScheduleCache()
    sc.insert(64, 128, 384, "FP32",
              CachedChoice(dataflow=Dataflow.OS, array=ArrayShape(16, 16),
                           k_fold=8, direction=Direction.LATERAL,
                           cycles=1.0, traffic_bytes=1.0))
    rng = np.random.default_rng(11)
    a = rng.standard_normal((64, 384)).astype(np.float32)
    b = rng.standard_normal((384, 128)).astype(np.float32)
    out = TOPS.matmul(torch.from_numpy(a), torch.from_numpy(b), schedule=sc,
                      blocks=(64, 64, 128))
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    (key, applied), = sc.applied
    assert key == (64, 128, 384, "FP32")
    assert applied.k_fold == TMP.effective_fold(384, 128, 8) == 3
    assert sc.stats()["hits"] == 1 and sc.stats()["misses"] == 0


def test_scheduled_fold_survives_block_choice():
    """A scheduled fold the chosen bk cannot host drops bk to FOLD_GRAIN
    (the reference's rule), so the fold executes as scheduled."""
    sc = ScheduleCache()
    sc.insert(8, 64, 900, "FP32",
              CachedChoice(dataflow=Dataflow.IS, array=ArrayShape(8, 32),
                           k_fold=8, direction=Direction.LATERAL,
                           cycles=1.0, traffic_bytes=1.0))
    a = torch.randn(8, 900, dtype=torch.float32)
    b = torch.randn(900, 64, dtype=torch.float32)
    out = TOPS.matmul(a, b, schedule=sc)
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)
    assert sc.applied[-1][1].k_fold == 8


def test_hopper_tiling_fits_the_card():
    for (M, N, K), df in itertools.product(
            ((8, 151936, 896), (256, 4864, 896), (8, 896, 4864),
             (33, 129, 257)), (Dataflow.OS, Dataflow.WS, Dataflow.IS)):
        c = tiling.choose_block_config(M, N, K, df)
        assert (c.bm, c.bn) in tiling.KERNEL_TILES and c.bk % tiling.KSTEP == 0
        assert tiling.smem_bytes(c.bm, c.bn, c.bk, df) <= tiling.SMEM_BYTES
    # the LM head under IS (the schedule the cache picks for it) spreads
    # its 151936 columns over at least one wave of the 132 SMs
    c = tiling.choose_block_config(8, 151936, 896, Dataflow.IS)
    ctas, _ = tiling.stream_split(8, 151936, c.bm, c.bn, Dataflow.IS)
    assert ctas >= tiling.NUM_SMS

