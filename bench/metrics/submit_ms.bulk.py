"""submit_ms.bulk: per wave, the wall time of the `LogicEngine.submit`
(or `submit_chain`) calls that refill the engine (the program cache's
lookup, the request and its chunks queued), from the harness's spans
around them (ms)."""
from benchkit.readers import per_wave_ms


def read(run):
    return per_wave_ms(run, "engine.submit")
