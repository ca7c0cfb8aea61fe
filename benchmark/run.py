"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything
it uses is found by name under ``benchmark/`` (README.md). The run needs
as many CUDA cards as the cell asks for and never falls back to the CPU.
Its standard output ends with one JSON line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``check``: each compared number beside its limit); the last lines of
its standard error repeat those numbers.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    chips = int(spec.workload(spec.load_spec(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_process=T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}, which it must not",
              file=sys.stderr)
        return 3
    leaks = harness.reference_leaks(spec.config(
        spec.workload(spec.load_spec(), args.workload)["config"]))
    if leaks:
        print(f"benchmark: the reference holds the program's {leaks}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    for name, row in result["check"].items():
        ok = "ok" if row["value"] <= row["limit"] else "FAIL"
        print(f"check {name} {row['value']!r} limit {row['limit']!r} {ok}",
              file=sys.stderr)
    print(f"check correct {result['correct']} failed {result['failed']} "
          f"of {result['attempted']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
