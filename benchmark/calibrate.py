"""Readings for the limits of a cell's check, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell with a window of
``seconds``, then the numbers of ``check.py`` twice: the program's
outputs against the reference, and the control's (the reference computed
a precision below what the configuration states, in the program's place,
from the same inputs) against the reference. One JSON line a seed. The
lower reading of a limit is the largest the program gives over a dozen
seeds or more, the upper the smallest the control gives (PERF.md).

``--phases STEPS STRIDE`` adds, for each seed, a sweep of the ``end``
stage over the phases of a run: an engine of the configuration steps
from the seed's state, and every STRIDE steps the check's steps are read
against the reference and the control, by every statistic of
``check.STATS``, up to STEPS steps. The window
leaves its state at whatever step it reaches, so the end stage's lower
reading is the largest over those phases.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--phases", type=int, nargs=2, default=None,
                    metavar=("STEPS", "STRIDE"))
    args = ap.parse_args(argv)

    import torch

    from benchmark import check, harness, traffic

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, args.seconds, False, "cuda",
                          time.perf_counter())
        traffic.DRIVERS[run.traffic["kind"]](run)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        nums, cnums = check.judge(run.config, run.cell["check"], run.init,
                                  run.params, run.outputs, "cuda",
                                  with_control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": nums, "control": cnums,
                          "check_s": time.perf_counter() - t,
                          "setup_s": run.setup_s, "steps": run.steps,
                          "failed": run.failed}), flush=True)
        config, k_steps = run.config, int(run.cell["check"]["steps"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
        if args.phases:
            for row in phases(config, seed, k_steps, *args.phases):
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  **row}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


def phases(config: dict, seed: int, k_steps: int, steps: int, stride: int,
           device: str = "cuda"):
    """Rows {"phase", "program", "control"} of the end stage every
    ``stride`` steps of a run from the seed's state."""
    from benchmark import check, state, traffic

    args = traffic.cli_args(config, device)
    eng = traffic.build_engine(args)
    init = state.initial(config, seed, device)
    restart = traffic.installer(eng, init)
    params = traffic.sim_params(args)
    pdict = dataclasses.asdict(params)
    mod = check.reference_module(config)
    ref, ctrl = mod.make(config, device), mod.make(config, device, "bfloat16")
    f32 = mod.make(config, device, "float32")
    restart()
    n, k = init.n, 0
    while k < steps:
        st = eng.state
        p_in = st.pos.reshape(3, -1)[:, :n].clone()
        v_in = st.vel.reshape(3, -1)[:, :n].clone()
        for _ in range(k_steps):
            eng.step(params)
        st = eng.state
        out = (st.pos.reshape(3, -1)[:, :n].clone(),
               st.vel.reshape(3, -1)[:, :n].clone())
        rp, rv, cell = ref.steps(p_in, v_in, init.masses, pdict, k_steps)
        wit = f32.steps(p_in, v_in, init.masses, pdict, k_steps)[:2]
        cp, cv, _ = ctrl.steps(p_in, v_in, init.masses, pdict, k_steps)
        yield {"phase": k,
               "program": check.step_numbers("end", out, (rp, rv), v_in, cell,
                                             check.STATS, wit),
               "control": check.step_numbers("end", (cp, cv), (rp, rv), v_in,
                                             cell, check.STATS, wit)}
        del p_in, v_in, out, rp, rv, cp, cv, wit
        for _ in range(stride - k_steps):
            eng.step(params)
        k += stride


if __name__ == "__main__":
    raise SystemExit(main())
