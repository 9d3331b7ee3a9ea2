"""samples_per_s: samples completed in the window over the window's
seconds (the window closes when its last wave does)."""


def read(run):
    return run.samples / run.window_s if run.window_s else None
