"""The viewer of a served cell, in a process of its own.

The served driver (``traffic.py``) starts this script beside the server's
process, as a browser is a process of its own: the client's reads and
sends never wait for the server's interpreter. It imports no torch. It
reads one JSON line of parameters on its standard input, then:

  1. connects to ``/ws`` (``wsclient.py``: one thread, one loop that
     reads frames and sends each event at its due time) and waits for a
     first frame;
  2. sends the mix's events for ``warmup_s`` (not measured), prints
     ``ready`` and waits for a ``go`` line;
  3. prints ``t0 <perf_counter>`` and sends the window's events open loop
     at their due times (``gap_schedule``, ``orbit_event``);
  4. after the window waits, a minute at most, for a frame reflecting the
     last event, then sends ``pause`` and waits for the paused frame;
  5. writes the frames' receipt times and headers, the events' due times
     and the paused frame into the files it was given, prints ``done``.

``time.perf_counter`` is the system's monotonic clock, the same in both
processes.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import wsclient  # noqa: E402


def gap_schedule(seed: int, seconds: float, mean_gap: float) -> np.ndarray:
    """Gaps (s) of the window's events: the quantiles of an exponential
    distribution of mean ``mean_gap``, scaled to sum to ``seconds``, in
    an order drawn from ``seed``."""
    m = max(int(round(seconds / mean_gap)), 1)
    q = -np.log(1.0 - (np.arange(m) + 0.5) / m)
    gaps = q * (seconds / q.sum())
    return np.random.default_rng(seed).permutation(gaps)


def orbit_event(orbit: dict, t: float, phase: float) -> dict:
    """A ``camera`` pose circling the origin at ``t`` seconds."""
    a = phase + orbit["rad_per_s"] * t
    r = orbit["radius"]
    pos = [r * math.sin(a), orbit.get("height", 0.0), r * math.cos(a)]
    return {"type": "camera", "pos": pos,
            "yaw": math.atan2(-pos[2], -pos[0]), "pitch": 0.0}


def _reflected(seq: int):
    return lambda fr: bool(fr) and fr[-1].header.reflected_seq >= seq


def _schedule(t0: float, gaps, orbit: dict, phase: float,
              seq: int) -> list:
    """(due time, event) of each gap, the first due at ``t0``."""
    dues = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [(float(d), {**orbit_event(orbit, float(d) - t0, phase),
                        "seq": seq + 1 + k}) for k, d in enumerate(dues)]


def main() -> int:
    p = json.loads(sys.stdin.readline())
    seed, orbit = int(p["seed"]), p["orbit"]
    phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))
    mean_gap = float(p["mean_gap_s"])
    client = wsclient.Client("127.0.0.1", int(p["port"]))
    try:
        seq = 0
        if not client.pump(time.perf_counter() + 120.0,
                           stop=_reflected(seq)):
            raise RuntimeError("the server sent no frame")
        warm = _schedule(time.perf_counter(),
                         gap_schedule(seed + 1, float(p["warmup_s"]),
                                      mean_gap), orbit, phase, seq)
        seq += len(warm)
        client.pump(warm[-1][0], sends=warm)
        if not client.pump(time.perf_counter() + 120.0,
                           stop=_reflected(seq)):
            raise RuntimeError("no frame reflected the warm-up events")
        print("ready", flush=True)
        sys.stdin.readline()

        t0 = time.perf_counter()
        print(f"t0 {t0!r}", flush=True)
        client.late.clear()
        events = _schedule(t0, gap_schedule(seed, float(p["seconds"]),
                                            mean_gap), orbit, phase,
                           seq)
        first, seq = seq + 1, seq + len(events)
        client.pump(t0 + float(p["seconds"]), sends=events)
        client.pump(time.perf_counter() + 60.0, stop=_reflected(seq))
        frames = list(client.frames)
        late = list(client.late)
        client.keep_paused = True
        client.send({"type": "pause", "seq": seq + 1})
        client.pump(time.perf_counter() + 60.0,
                    stop=lambda fr: client.paused_frame is not None)
        if client.paused_frame is not None:
            with open(p["paused_file"], "wb") as f:
                f.write(client.paused_frame)
        with open(p["result_file"], "w") as f:
            json.dump({"t0": t0, "dues": [d for d, _ in events],
                       "first": first, "last_seq": seq, "late": late,
                       "frames": [[r.t, *r.header] for r in frames]}, f)
    finally:
        client.close()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
