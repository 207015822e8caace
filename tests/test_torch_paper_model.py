"""Port parity: the paper's analytic layer (pure Python, no kernels).

For every one of the nine Table-2 workloads the port's copies of
``core.workloads``, ``core.pgemm``, ``core.scheduler`` and
``core.simulator`` give what the reference's give: the same operator
lists and routing, the same schedule per p-GEMM (dataflow, array, fold,
direction, cycles, traffic), and the same simulator results for GTA and
the three baselines.  Both sides run the same arithmetic in the same
order, so results are compared exactly; the precision helpers reproduce
Table 3.
"""

import pytest

from repro.core import pgemm as JP
from repro.core import precision as JPR
from repro.core import scheduler as JS
from repro.core import simulator as JSIM
from repro.core import workloads as JW
from repro_torch.core import pgemm as TP
from repro_torch.core import precision as TPR
from repro_torch.core import scheduler as TS
from repro_torch.core import simulator as TSIM
from repro_torch.core import workloads as TW

NAMES = ["BNM", "RGB", "FFE", "MD", "PCA", "ALT", "FFL", "ALI", "NERF"]


def _op(op):
    """An operator as a plain tuple (kind, fields, derived metrics)."""
    if type(op).__name__ == "PGEMM":
        fields = (op.name, op.M, op.N, op.K, op.precision.name, op.batch)
    else:
        fields = (op.name, op.n_elems, op.precision.name, op.ops_per_elem)
    return (type(op).__name__, fields, op.flops, op.min_bytes,
            op.arithmetic_intensity, op.parallelism)


def _report(r):
    s = r.schedule
    return (s.dataflow.value, s.array.rows, s.array.cols, s.pattern.value,
            s.k_fold, s.direction.value, r.cycles, r.traffic_bytes,
            r.utilization)


def _result(r):
    return (r.name, r.cycles, r.traffic_bytes)


def test_workload_registry_matches_reference():
    assert list(TW.WORKLOADS) == list(JW.WORKLOADS) == NAMES
    assert {k: p.name for k, p in TW.WORKLOAD_PRECISION.items()} == \
        {k: p.name for k, p in JW.WORKLOAD_PRECISION.items()}
    assert TW.workload("md") is TW.WORKLOADS["MD"]
    with pytest.raises(KeyError):
        TW.workload("nope")


@pytest.mark.parametrize("name", NAMES)
def test_operators_and_routing_match_reference(name):
    tops, jops = TW.workload(name), JW.workload(name)
    assert [_op(o) for o in tops] == [_op(o) for o in jops]
    assert [TP.classify(o).value for o in tops] == \
        [JP.classify(o).value for o in jops]
    tg, tv = TP.split_paths(tops)
    jg, jv = JP.split_paths(jops)
    assert [_op(o) for o in tg] == [_op(o) for o in jg]
    assert [_op(o) for o in tv] == [_op(o) for o in jv]
    assert TP.total_flops(tops) == JP.total_flops(jops)


@pytest.mark.parametrize("name", NAMES)
def test_schedules_match_reference(name):
    tg, _ = TP.split_paths(TW.workload(name))
    jg, _ = JP.split_paths(JW.workload(name))
    tch = TS.schedule_workload(tg, TS.GTAConfig(lanes=4))
    jch = JS.schedule_workload(jg, JS.GTAConfig(lanes=4))
    assert len(tch) == len(jch) == len(tg)
    for t, j in zip(tch, jch):
        assert _report(t.best) == _report(j.best)
        assert (t.cycles, t.traffic_bytes) == (j.cycles, j.traffic_bytes)
        assert [_report(r) for r in t.space] == [_report(r) for r in j.space]


@pytest.mark.parametrize("name", NAMES)
def test_simulators_match_reference(name):
    tops, jops = TW.workload(name), JW.workload(name)
    pairs = [(TSIM.GTASim(), JSIM.GTASim()),
             (TSIM.GTASim(TS.GTAConfig(lanes=256)),
              JSIM.GTASim(JS.GTAConfig(lanes=256))),
             (TSIM.VPUSim(), JSIM.VPUSim()),
             (TSIM.GPGPUSim(), JSIM.GPGPUSim()),
             (TSIM.CGRASim(), JSIM.CGRASim())]
    for t, j in pairs:
        assert _result(t.run(tops)) == _result(j.run(jops))
    for base in JSIM.BASELINES:
        tg, tb = TSIM.compare_vs(base, tops)
        jg, jb = JSIM.compare_vs(base, jops)
        assert _result(tg) == _result(jg)
        assert _result(tb) == _result(jb)
        assert TSIM.speedup_and_mem_eff(tg, tb) == \
            JSIM.speedup_and_mem_eff(jg, jb)


def test_area_parity_constants_match_reference():
    assert TSIM.PARITY_LANES == JSIM.PARITY_LANES
    assert TSIM.GPGPU_EQUIV_LANES == JSIM.GPGPU_EQUIV_LANES
    assert TSIM.CGRA_EQUIV_LANES == JSIM.CGRA_EQUIV_LANES
    for lanes in (1, 4, 13, 64, 256, TSIM.GPGPU_EQUIV_LANES):
        t, j = TS.GTAConfig(lanes=lanes), JS.GTAConfig(lanes=lanes)
        assert (t.total_pes, t.group_lanes, t.groups) == \
            (j.total_pes, j.group_lanes, j.groups)
        assert t.arrangements() == [TS.ArrayShape(a.rows, a.cols)
                                    for a in j.arrangements()]


def test_simd_gain_reproduces_table_3():
    table3 = {"INT8": 8.0, "INT16": 4.0, "INT32": 2.0, "INT64": 1.0,
              "BP16": 16.0, "FP16": 4.0, "FP32": 64 / 9 / 2,
              "FP64": 64 / 49}
    for name, gain in table3.items():
        t, j = TPR.precision(name), JPR.precision(name)
        assert TPR.simd_gain(t) == pytest.approx(gain, rel=1e-12)
        assert TPR.simd_gain(t) == JPR.simd_gain(j)
        assert (TPR.ws_row_expansion(t), TPR.os_expansion(t),
                TPR.vector_pes_per_mult(t), t.is_float, str(t)) == \
            (JPR.ws_row_expansion(j), JPR.os_expansion(j),
             JPR.vector_pes_per_mult(j), j.is_float, str(j))
    assert TPR.precision("bf16") is TPR.BP16
    with pytest.raises(KeyError):
        TPR.precision("int4")


def test_limb_algebra_matches_reference():
    for bits, lb in ((32, 8), (32, 7), (53, 8), (64, 16)):
        assert TPR.limb_count(bits, lb) == JPR.limb_count(bits, lb)
        n = TPR.limb_count(bits, lb)
        assert TPR.limb_weights(n, lb) == JPR.limb_weights(n, lb)
        assert TPR.product_limb_pairs(n) == JPR.product_limb_pairs(n)


def test_pgemm_rewrites_match_reference():
    kw = dict(batch=2, in_ch=3, out_ch=8, img_hw=(17, 19),
              kernel_hw=(3, 5), stride=2, pad=1)
    cases = [
        ("conv2d_as_pgemm", ("c",), kw),
        ("linear_as_pgemm", ("l",), dict(batch_tokens=7, d_in=9, d_out=5)),
        ("mttkrp_as_pgemm", ("m",), dict(i=4, j=5, k=6, r=3)),
        ("bignum_mult_as_pgemm", ("b",), dict(digits_bits=2048,
                                              n_mults=16)),
        ("attention_scores_as_pgemm", ("a",),
         dict(q_tokens=4, kv_tokens=33, d_head=64, heads=8)),
    ]
    for fn, args, kwargs in cases:
        for p in ("INT8", "INT64", "FP32"):
            t = getattr(TP, fn)(*args, **kwargs,
                                precision=TPR.precision(p))
            j = getattr(JP, fn)(*args, **kwargs,
                                precision=JPR.precision(p))
            assert _op(t) == _op(j)
            assert _op(t.scaled("s", M=3)) == _op(j.scaled("s", M=3))
    assert (TP.GEMM_REUSE_THRESHOLD, TP.VECTOR_PARALLELISM_CAP) == \
        (JP.GEMM_REUSE_THRESHOLD, JP.VECTOR_PARALLELISM_CAP)


@pytest.mark.parametrize("name", ["MD", "FFE", "ALI", "FFL"])
def test_pareto_helpers_match_reference(name):
    tg, _ = TP.split_paths(TW.workload(name))
    jg, _ = JP.split_paths(JW.workload(name))
    for t_op, j_op in zip(tg[:4], jg[:4]):
        t = TS.explore(t_op, TS.GTAConfig(lanes=4))
        j = JS.explore(j_op, JS.GTAConfig(lanes=4))
        assert [_report(r) for r in TS.pareto_front(t.space)] == \
            [_report(r) for r in JS.pareto_front(j.space)]
        assert TS.is_on_or_dominated_boundary(t.best, t.space)
        assert [TS.is_on_or_dominated_boundary(r, t.space)
                for r in t.space] == \
            [JS.is_on_or_dominated_boundary(r, j.space) for r in j.space]
