"""Put something else in the timed path's place, for the control and the
fault checks: every runner of the engine's served entries is replaced,
after set-up, by ``make(runner, ctx)``'s result.  The harness's own runs
never do this; ``bench/tools/control.py`` and ``bench/tests`` do."""
from __future__ import annotations

import numpy as np

from benchkit import program


def runners(make):
    """A harness hook that swaps each served runner for ``make(old, ctx)``."""
    def hook(engine, ctx):
        entries = program.served_entries(engine)
        if not entries:
            raise RuntimeError("no served entry to swap")
        for entry in entries:
            for key, old in list(entry.runners.items()):
                entry.runners[key] = make(old, ctx)
    return hook


def control(old, ctx):
    """The reference in TF32, in the program's place."""
    from reference.control import tf32_stack
    return lambda bits: tf32_stack(bits, ctx.layers, ctx.device)


def unchanged(old, ctx):
    """A step that leaves every answer as it was made: nothing computed."""
    n_out = ctx.layers[-1].W.shape[1]
    return lambda bits: np.zeros((len(bits), n_out), dtype=bool)


def _active(bits) -> np.ndarray:
    """The rows of a wave's slab that hold a sample (no served pattern is
    all zeros; the slab's free rows are)."""
    return np.flatnonzero(np.asarray(bits).any(axis=1))


def half(old, ctx):
    """Half of each wave left out: every other sample never computed."""
    def run(bits):
        out = np.array(old(bits))
        out[_active(bits)[1::2]] = False
        return out
    return run


def altered(old, ctx):
    """One answer altered where it is produced: one bit of a sample of
    each wave flipped, the sample and the bit drawn from the run's seed."""
    rng = ctx.rng("fault")

    def run(bits):
        out = np.array(old(bits))
        rows = _active(bits)
        if len(rows):
            out[rows[rng.integers(len(rows))],
                rng.integers(out.shape[1])] ^= True
        return out
    return run


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
