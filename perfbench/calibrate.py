"""Readings that the check's limits are set from, at a cell's own size on
the card, in one process: the program's numbers and the control's on
each of --seeds, then each of --faults (perfbench/faults.py) planted on
each of --fault-seeds. One JSON line a run on standard output:

  python3 perfbench/calibrate.py --workload <name> --seconds 4 \
      --seeds 1 2 3 --faults scores_swapped --fault-seeds 4 5 6

A benchmark run never calls this. Its windows are short: long enough to
keep as many rows as a run's check compares.
"""

import runpy
import time
from pathlib import Path

T0 = time.perf_counter()
# run.py's set-up: the import path, the bytecode and the kernels' caches.
runpy.run_path(str(Path(__file__).with_name("run.py")), run_name="setup")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import faults, harness  # noqa: E402

DEVICE = "cuda"


def reading(name, spec, seed, seconds, fault=None):
    res = harness.run_cell(name, seed, seconds, False, DEVICE,
                           t0=time.perf_counter(), spec=spec,
                           control=fault is None)
    lat = res["latency"]
    return {"workload": name, "seed": seed, "fault": fault,
            "correct": res["correct"], "failed": res["failed"],
            "batches": lat["batches"], "rows": lat["rows"],
            "landed": lat["landed"], "program": res["numbers"]["program"],
            "control": res["numbers"]["control"], "limits": res["limits"]}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, f) for f in args.faults for seed in args.fault_seeds]
    for seed, fault in runs:
        if fault is None:
            line = reading(args.workload, spec, seed, args.seconds)
        else:
            with faults.FAULTS[fault](spec):
                line = reading(args.workload, spec, seed, args.seconds,
                               fault)
        print(json.dumps(line), flush=True)
    print(f"card {harness.card_line()}; {time.perf_counter() - T0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
