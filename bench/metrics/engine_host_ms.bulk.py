"""engine_host_ms.bulk: per wave, the wall time of `LogicEngine.step`
less that of its runner (the slot table, the slab built and scattered on
the host), from the harness's spans around both (ms)."""
from benchkit.readers import engine_host_ms


def read(run):
    return engine_host_ms(run)
