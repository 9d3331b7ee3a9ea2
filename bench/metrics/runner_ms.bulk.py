"""runner_ms.bulk: the wall time of the engine's runner per wave (H2D,
pack_bits, the K2 launch, unpack_bits, D2H), from the harness's span
around the cache entry's runner (ms)."""
from benchkit.readers import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner")
