"""The derived number of each of the paper's tables as the reference's
``benchmarks/paper_tables.py`` computes it: held against the reference
by ``tests/test_torch_paper_tables.py`` on the CPU and against the port's
``repro_torch.launch.paper_tables`` by ``chip_smoke.py`` on the card
machine, which reads this file, so it imports nothing."""

DERIVED = {
    "table3_simd": 0.004709576138147452,
    "fig6_energy": 3.8826086956521744,
    "fig7_vpu": {"speedup_mean": 5.17, "speedup_geomean": 3.56,
                 "mem_mean": 20.68, "mem_geomean": 9.94,
                 "paper_speedup": 6.45, "paper_mem": 7.76,
                 "parity_lanes": 4},
    "fig8_gpgpu": {"speedup_mean": 5.82, "speedup_geomean": 2.0,
                   "mem_mean": 2.91, "mem_geomean": 1.63,
                   "paper_speedup": 3.39, "paper_mem": 5.35,
                   "parity_lanes": 17094},
    "fig9_schedule": 225,
    "fig10_cgra": {"speedup_mean": 36.44, "speedup_geomean": 18.38,
                   "mem_mean": 13.94, "mem_geomean": 5.89,
                   "paper_speedup": 25.83, "paper_mem": 8.76,
                   "parity_lanes": 13},
}
#: rows of each table
ROWS = {"table3_simd": 8, "fig6_energy": 24, "fig7_vpu": 9,
        "fig8_gpgpu": 9, "fig9_schedule": 225, "fig10_cgra": 9}
