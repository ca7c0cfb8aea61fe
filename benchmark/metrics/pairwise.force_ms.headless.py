"""pairwise.force_ms.headless: device milliseconds a step inside the
program's pairwise.force spans (ops/pairwise_cuda.py step_pairwise: the
pair kernel of csrc/pairwise.cu and its slice sum), over the engine.step
spans of the traced window."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per_step(run, ("pairwise.force",))
