"""Readings that set the limits of a cell's check, made on the chip at
the cell's own size (the benchmark's runs never make them):

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 --mode program
    python3 bench/readings.py --workload <cell> --seeds 1,2,3 --mode control
    python3 bench/readings.py --workload <cell> --seeds 1,2,3 --mode fault:<name>

``program`` gives the program's numbers with every reading behind them
(per leaf).  ``control`` gives the numbers of the control: the plain
reference in TF32, the nearest precision below the configuration's
float32, in the program's place.  ``fault:<name>`` runs the cell with
that fault planted in the timed path (``half_batch`` or
``frozen_state`` for training) and gives its numbers.  One JSON line a
seed on standard output.
"""

import argparse
import json
import sys
import time

from run import ROOT, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import core
    cell = core.Cell(args.workload, ROOT)
    driver = cell.driver()
    device = torch.device("cuda", 0)
    seconds = args.seconds or core.load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        run = core.Run(cell, seed, seconds, False, time.perf_counter())
        t0 = time.perf_counter()
        if args.mode == "control" and hasattr(driver, "control"):
            out = driver.control(run, device)
        else:
            opts = ({} if args.mode == "program"
                    else {"control": True} if args.mode == "control"
                    else {"fault": args.mode.split(":", 1)[1]})
            o = driver.run(run, device, opts)
            out = {"values": {k: c["value"] for k, c in o.checks.items()},
                   "readings": o.readings}
        out.update(workload=cell.name, seed=seed, mode=args.mode,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
