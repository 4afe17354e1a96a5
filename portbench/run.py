"""Benchmark of the PyTorch/CUDA port ``strugatzki_tpu_torch`` on NVIDIA
cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell is looked up in
``BENCHMARK.json``.  Set-up (imports, CUDA, data from the seed, staging,
warm-up) counts from process start; then whole units of the cell's traffic
run back to back for ``--seconds``.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics, or with ``--trace 1`` the per-layer ones read from a
torch.profiler stretch), ``device`` (and ``breakdown`` when traced), and
last ``checks``, each compared number with its limit; the same numbers are
the last lines of standard error.  The cell runs on its ``chips`` cards,
``cuda:0`` onwards: ``device.count`` is that number, ``memory_peak_bytes``
the fullest card's peak, and a traced run's ``busy_s`` a card's on
average.  With fewer CUDA cards than the cell asks for, without the
program beside the benchmark, or if the process holds a JAX module when the
window has closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "strugatzki_tpu_torch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        print(f"portbench: the program {PROGRAM} is not in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    import torch
    from portbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}
    if args.workload not in chips:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"portbench: needs {chips[args.workload]} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    line, checks = harness.run_cell(bench, args.workload, args.seed,
                                    args.seconds, bool(args.trace), "cuda",
                                    T_START)
    found = harness.banned_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
