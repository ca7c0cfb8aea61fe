"""render.device_ms.served: device milliseconds per
Engine.render_frame_device call of the server's pack thread (the raster
wire's frame on the card)."""


def read(run):
    if run.trace is None:
        return None
    label = "Engine.render_frame_device"
    secs, count = run.trace.device_time(label)
    calls = run.trace.span_count(label)
    return secs / calls * 1e3 if count and calls else None
