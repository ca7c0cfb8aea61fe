"""pm.solve_ms.headless: device milliseconds a step of the PM solve's
cuFFT transforms and spectral multiplies, launched inside Engine.step
(kernel names matched by PATTERNS), over the steps traced."""

#: cuFFT's kernels, and the complex multiply of the spectra.
PATTERNS = (r"fft", r"FFT", r"[sd]pRadix", r"MulFunctor<c10::complex")


def read(run):
    if run.trace is None:
        return None
    secs, count = run.trace.device_time("Engine.step", PATTERNS)
    steps = run.trace.span_count("Engine.step")
    if not count or not steps:
        return None
    return secs / steps * 1e3
