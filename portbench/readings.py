"""The readings the correctness limits are set from, many seeds in one
process (set-up, the kernels' generation above all, is paid once):

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--controls tf32,bf16] \
        [--faults half_batch,altered --fault-seeds 31,32,33] [--capped-seeds 41,42]

For each seed it builds and sets up the cell as a run does
(``harness.prepare``), drives the window's units that the check records
(``check_units``), then frees the program's state and runs the check
(``harness.judge``): the sound reading, a control (the reference computed
in a lower precision in the program's place), a planted fault, or with
``--capped-seeds`` the sound program against the reference with the MJX
contact caps left in (the kernels evaluate every pair). One JSON line per
reading: the cell, the seed, the mode and each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(HERE, "reference")]


def ints(text: str):
    return [int(x) for x in text.split(",") if x]


def reading(cell, seed: int, mode: str, device) -> dict:
    import judge
    import refcell

    from portbench import harness, program

    t0 = time.perf_counter()
    drv = harness.prepare(cell, seed, device, mode if mode in program.FAULTS else None)
    for i in range(drv.check_units()):
        drv.unit(i)
    uncapped = refcell.pipeline.uncapped
    if mode == "capped":
        refcell.pipeline.uncapped = lambda m: m
    try:
        numbers, notes = harness.judge(drv, mode if mode in judge.CONTROLS else None)
    finally:
        refcell.pipeline.uncapped = uncapped
    return {"cell": cell.name, "seed": seed, "mode": mode,
            "numbers": {n.name: n.value for n in numbers},
            "seconds": time.perf_counter() - t0, "notes": notes[-3:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--controls", default="tf32,bf16")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=ints, default=[])
    ap.add_argument("--capped-seeds", type=ints, default=[])
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        raise SystemExit("readings: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    plan = ([(s, "sound") for s in args.seeds]
            + [(s, c) for c in args.controls.split(",") if c for s in args.control_seeds]
            + [(s, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
            + [(s, "capped") for s in args.capped_seeds])
    for seed, mode in plan:
        print(json.dumps(reading(cell, seed, mode, torch.device("cuda", 0))), flush=True)


if __name__ == "__main__":
    main()
