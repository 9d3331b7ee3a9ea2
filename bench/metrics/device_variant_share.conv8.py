"""device_variant_share.conv8: the share of the window's K2 launches
that ran the device-scratch variant (%), from the launch plan the
program's `runner.kernel` span notes (`scratch`); None where the port
notes no plan."""
from benchkit.program_spans import in_window


def read(run):
    plans = [s.attrs["scratch"] for s in in_window(run)
             if s.label == "runner.kernel" and "scratch" in s.attrs]
    if not plans:
        return None
    return 100.0 * plans.count("device") / len(plans)
