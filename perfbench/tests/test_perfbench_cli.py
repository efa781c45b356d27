"""The command: it prints no result and fails without a card; a card
test runs each cell briefly where there is one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cell, seconds, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900, env=env)


def test_no_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = run(CELLS[0], 1, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    p = run(cell, 3)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
