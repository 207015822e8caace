"""Port parity: the paper's Table 3 and Figs. 6-10
(``repro_torch.launch.paper_tables``) against
``benchmarks/paper_tables.py``: every row and every derived number equal,
and the claims and constants the same; the reference's derived numbers
equal ``tests/_paper_expected.py``, which ``chip_smoke.py`` holds the
port to where there is no reference.  Host arithmetic over the analytic
layer; nothing is timed."""

import pytest

from benchmarks import paper_tables as REF
from _paper_expected import DERIVED, ROWS
from repro_torch.configs.gta_paper import GTA_4LANE
from repro_torch.launch import paper_tables as PT

TABLES = ("table3_simd", "fig6_energy", "fig7_vpu", "fig8_gpgpu",
          "fig9_schedule", "fig10_cgra")


@pytest.mark.parametrize("name", TABLES)
def test_table_rows_and_derived_equal_reference(name):
    rows, derived = getattr(PT, name)()
    want_rows, want_derived = getattr(REF, name)()
    assert rows == want_rows
    assert derived == want_derived
    # the values chip_smoke.py holds the port to on the card machine
    assert want_derived == DERIVED[name] and len(want_rows) == ROWS[name]


def test_claims_and_constants_equal_reference():
    assert PT.PAPER_CLAIMS == REF.PAPER_CLAIMS
    assert PT.TABLE3_PAPER == REF.TABLE3_PAPER
    assert (PT.E_MAC8_NJ, PT.E_CTRL_NJ, PT.E_ACC_NJ) == (
        REF.E_MAC8_NJ, REF.E_CTRL_NJ, REF.E_ACC_NJ)
    from repro.configs.gta_paper import GTA_4LANE as REF_4LANE
    assert (GTA_4LANE.lanes, GTA_4LANE.total_pes, GTA_4LANE.group_lanes) \
        == (REF_4LANE.lanes, REF_4LANE.total_pes, REF_4LANE.group_lanes)


def test_cli_prints_each_derived_line(capsys):
    PT.main(["table3", "fig6", "fig9"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,derived"
    _rows, worst = REF.table3_simd()
    assert f"table3_simd,worst_rel_err={worst:.4f}" in out
    _rows, spread = REF.fig6_energy()
    assert f"fig6_energy,max_min_energy_spread={spread:.2f}x" in out
    _rows, n = REF.fig9_schedule()
    assert f"fig9_schedule,points={n}" in out
    chosen = [line for line in out if line.startswith("  chosen[")]
    assert len(chosen) == 3
    with pytest.raises(SystemExit):
        PT.main(["fig11"])
