"""setup_s: from the start of the process to the first measured step or
event: the CUDA context, the kernel library loaded from the checkout's
build directory (built there by the first run), the engine and its
state, the host spectra, the server and the warm-up."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
