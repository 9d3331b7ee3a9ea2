"""gc_ms.bulk: milliseconds a second of the window the interpreter spent
in garbage collection, from the harness's `gc.callbacks` spans: host
time that stalls every thread of the program."""
from benchkit.readers import per_window_ms


def read(run):
    return per_window_ms(run, "gc")
