"""frames_per_s: the distinct frame ids the client received in the window
over the window's seconds (host clock)."""


def read(run):
    if run.window_s <= 0 or not run.frames_in_window:
        return None
    return run.frames_in_window / run.window_s
