"""Readings that set the limits of ``correct``, for one cell on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --variant program|control

runs the cell once per seed in one process (set-up, a short window at the
cell's own load, the check) and prints one JSON line per seed with the
compared numbers.  ``program`` gives the lower readings, sound runs of the
program; ``control`` gives the upper ones: the configuration's control (the
reference computed in the precision below the configuration's, or the
program's own lower-precision path) put in the program's place.  The
benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variant", choices=("program", "control"),
                   default="program")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    variant = None if args.variant == "program" else "control"
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        line, checks = harness.run_cell(bench, args.workload, seed,
                                        args.seconds, False, "cuda", t,
                                        variant=variant)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant,
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "setup_s": line["metrics"].get("setup_s", {})
                          .get("value"),
                          "checks": {n: v for n, v, _ in checks}}),
              flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
