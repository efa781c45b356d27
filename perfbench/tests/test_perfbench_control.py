"""The control comes out not correct under each cell's own limits: the
reference put in the program's place one precision below the
configuration's (float8 e4m3 for bfloat16), at the cell's widths and
beams on a few rows, on the CPU. The program's plain route, which the
CPU runs, reads within the limits there. The readings at the cells' own
sizes on the card are in PERF.md."""

import json
from pathlib import Path

import pytest

from perfbench import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_limits(cell):
    spec = harness.cell_spec(cell, BENCH)
    spec["mix"] = dict(spec["mix"], batch=4)
    spec["workload"] = dict(spec["workload"], check_rows=4)
    res = harness.run_cell(cell, 2 ** 31 + 11, 0.01, False, "cpu", t0=0.0,
                           spec=spec, control=True)
    limits = res["limits"]
    assert check.verdict(res["numbers"]["program"], limits), res["numbers"]
    assert not check.verdict(res["numbers"]["control"],
                             {k: v for k, v in limits.items()
                              if k in res["numbers"]["control"]}), \
        res["numbers"]
