"""engine.step_device_ms.served: device milliseconds per Engine.step call
of the server's sim thread: the operations launched inside the span,
over the spans traced."""


def read(run):
    if run.trace is None:
        return None
    secs, count = run.trace.device_time("Engine.step")
    steps = run.trace.span_count("Engine.step")
    return secs / steps * 1e3 if count and steps else None
