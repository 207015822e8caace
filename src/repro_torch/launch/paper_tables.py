"""The paper's Table 3 and Figs. 6-10 from the analytic model in
``repro_torch.core`` (port of ``benchmarks/paper_tables.py``).

Each table function returns ``(rows, derived)``: printable dicts and the
headline number that stands beside the paper's claim.  These are outputs
of the model, not measurements, so nothing here is timed.

    python -m repro_torch.launch.paper_tables [table3|fig6|fig7|fig8|fig9|fig10|all]
"""

from __future__ import annotations

import statistics
import sys
from collections.abc import Callable

from repro_torch.configs.gta_paper import GTA_4LANE
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.pgemm import conv2d_as_pgemm
from repro_torch.core.precision import (ALL_PRECISIONS, BP16, FP32, INT8,
                                        simd_gain)
from repro_torch.core.scheduler import explore
from repro_torch.core.simulator import (PARITY_LANES, compare_vs,
                                        speedup_and_mem_eff)
from repro_torch.core.workloads import WORKLOADS

PAPER_CLAIMS = {
    "VPU-Ara": {"speedup": 6.45, "mem": 7.76},
    "GPGPU-H100": {"speedup": 3.39, "mem": 5.35},
    "CGRA-hycube": {"speedup": 25.83, "mem": 8.76},
}

TABLE3_PAPER = {"INT8": 8.0, "INT16": 4.0, "INT32": 2.0, "INT64": 1.0,
                "BP16": 16.0, "FP16": 4.0, "FP32": 3.56, "FP64": 1.3}


def table3_simd() -> tuple[list[dict], float]:
    """SIMD throughput gains of one MPRA lane over one Ara lane; derived:
    the worst relative error against the paper."""
    rows = []
    worst_err = 0.0
    for p in ALL_PRECISIONS:
        got = simd_gain(p)
        want = TABLE3_PAPER[p.name]
        err = abs(got - want) / want
        worst_err = max(worst_err, err)
        rows.append({"dtype": p.name, "limbs": p.limbs,
                     "gain_model": round(got, 2), "gain_paper": want,
                     "rel_err": round(err, 4)})
    return rows, worst_err


def _fig_compare(baseline: str) -> tuple[list[dict], dict[str, float]]:
    rows = []
    sp, me = [], []
    for name, ops in WORKLOADS.items():
        s, m = speedup_and_mem_eff(*compare_vs(baseline, ops))
        sp.append(s)
        me.append(m)
        rows.append({"workload": name, "speedup": round(s, 2),
                     "mem_eff": round(m, 2)})
    derived = {
        "speedup_mean": round(statistics.mean(sp), 2),
        "speedup_geomean": round(statistics.geometric_mean(sp), 2),
        "mem_mean": round(statistics.mean(me), 2),
        "mem_geomean": round(statistics.geometric_mean(me), 2),
        "paper_speedup": PAPER_CLAIMS[baseline]["speedup"],
        "paper_mem": PAPER_CLAIMS[baseline]["mem"],
        "parity_lanes": PARITY_LANES[baseline],
    }
    return rows, derived


def fig7_vpu():
    return _fig_compare("VPU-Ara")


def fig8_gpgpu():
    return _fig_compare("GPGPU-H100")


def fig10_cgra():
    return _fig_compare("CGRA-hycube")


def fig9_schedule() -> tuple[list[dict], int]:
    """Mixed precision x dataflow scheduling scatter of one AlexNet conv
    layer in three precisions; points are (cycles, traffic) normalized to
    the per-metric minimum, the explorer's pick marked ``chosen``."""
    rows = []
    for prec in (INT8, BP16, FP32):
        op = conv2d_as_pgemm("alexnet.conv2", batch=1, in_ch=96, out_ch=256,
                             img_hw=(27, 27), kernel_hw=(5, 5), pad=2,
                             precision=prec)
        choice = explore(op, GTA_4LANE)
        min_c = min(r.cycles for r in choice.space)
        min_t = min(r.traffic_bytes for r in choice.space)
        marked = False
        for r in choice.space:
            is_best = (not marked) and r == choice.best
            marked = marked or is_best
            rows.append({
                "precision": prec.name,
                "dataflow": r.schedule.dataflow.value,
                "array": f"{r.schedule.array.rows}x{r.schedule.array.cols}",
                "k_fold": r.schedule.k_fold,
                "cycles_norm": round(r.cycles / min_c, 3),
                "traffic_norm": round(r.traffic_bytes / min_t, 3),
                "chosen": is_best,
            })
    return rows, len(rows)


#: energy model constants (nJ), calibrated to the paper's Fig. 6
#: narrative: per-8-bit-MAC energy dominates, with control and
#: accumulator overhead per op; energy comes out roughly FLAT across
#: precisions and modes, since a wider precision does quadratically more
#: limb work on quadratically fewer ops.
E_MAC8_NJ = 0.25e-3
E_CTRL_NJ = 0.9e-3
E_ACC_NJ = 0.12e-3


def fig6_energy() -> tuple[list[dict], float]:
    """MPRA energy per (precision x mode), per 64-bit-equivalent op as
    in the paper's bar chart; derived: the max / min spread."""
    rows = []
    vals = []
    for p in ALL_PRECISIONS:
        limbs = p.limbs
        for mode in (Dataflow.WS, Dataflow.OS, Dataflow.SIMD):
            # one p-bit multiply is limbs^2 limb MACs wherever it runs; WS
            # adds accumulator passes per limb column, OS keeps partials
            # local, SIMD writes each element back to the VRF
            e = limbs * limbs * E_MAC8_NJ + E_CTRL_NJ
            if mode is Dataflow.WS:
                e += limbs * E_ACC_NJ
            elif mode is Dataflow.SIMD:
                e += E_ACC_NJ * 2
            e_norm = e * (64 // p.bits if p.bits <= 64 else 1)
            rows.append({"dtype": p.name, "mode": mode.value,
                         "energy_nj_per_64b_op": round(e_norm, 4)})
            vals.append(e_norm)
    return rows, max(vals) / min(vals)


def _print_table3() -> None:
    rows, worst_err = table3_simd()
    for r in rows:
        print(f"  {r['dtype']:5s} model {r['gain_model']:6.2f}x "
              f"paper {r['gain_paper']:5.2f}x")
    print(f"table3_simd,worst_rel_err={worst_err:.4f}")


def _print_fig(name: str, fn: Callable) -> None:
    rows, derived = fn()
    for r in rows:
        print(f"  {r['workload']:5s} speedup {r['speedup']:8.2f}x "
              f"mem {r['mem_eff']:7.2f}x")
    print(f"{name},speedup_mean={derived['speedup_mean']}x_vs_paper_"
          f"{derived['paper_speedup']}x;mem_geomean={derived['mem_geomean']}"
          f"x_vs_paper_{derived['paper_mem']}x")


def _print_fig9() -> None:
    rows, n = fig9_schedule()
    for c in (r for r in rows if r["chosen"]):
        print(f"  chosen[{c['precision']}]: {c['dataflow']} {c['array']} "
              f"fold={c['k_fold']} cyc={c['cycles_norm']} "
              f"mem={c['traffic_norm']}")
    print(f"fig9_schedule,points={n}")


def _print_fig6() -> None:
    _rows, spread = fig6_energy()
    print(f"fig6_energy,max_min_energy_spread={spread:.2f}x")


TABLES: dict[str, Callable[[], None]] = {
    "table3": _print_table3,
    "fig7": lambda: _print_fig("fig7_vpu", fig7_vpu),
    "fig8": lambda: _print_fig("fig8_gpgpu", fig8_gpgpu),
    "fig10": lambda: _print_fig("fig10_cgra", fig10_cgra),
    "fig9": _print_fig9,
    "fig6": _print_fig6,
}


def main(argv=None) -> None:
    which = list(sys.argv[1:] if argv is None else argv) or ["all"]
    if "all" in which:
        which = list(TABLES)
    bad = [w for w in which if w not in TABLES]
    if bad:
        raise SystemExit(f"unknown table {bad}; choose from "
                         f"{sorted(TABLES)} or all")
    print("name,derived")
    for name in which:
        TABLES[name]()


if __name__ == "__main__":
    main()
