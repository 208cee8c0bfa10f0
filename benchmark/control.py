"""Readings that a cell's limits are set from, on the card at the cell's
own size: the program's numbers on many seeds (sound runs, the lower
reading) and the control's on a few (the reference in the next precision
down put in the program's place, the upper reading), each after a short
window at the cell's own load.

    python3 benchmark/control.py --workload <cell> --seconds 12 \
        --seeds 11 12 13 ... --control 3 --out chiprun_out/<cell>.jsonl

One JSON line a seed: {"seed", "program": {...}, "control": {...}}. The
benchmark's own runs never run this; `tests/test_bench_control.py` runs
it at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    job = cell.driver.Job(cell.config, cell.traffic, seed, device)
    job.setup()
    job.window(seconds)
    job.release()
    if not control:
        return {"seed": seed, "program": job.check()}
    planted = job.control()
    program = planted.pop("program", None) or job.check()
    return {"seed": seed, "program": program, "control": planted}


def main(argv=None) -> int:
    run.setup_environment()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--control", type=int, default=3,
                   help="the first this many seeds also read the control")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = run.Cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(args.seeds):
            line = json.dumps(readings(cell, seed, args.seconds,
                                       k < args.control, args.device))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
