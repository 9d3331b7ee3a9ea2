"""The runner's staged-transfer share in a traced run of the tiny copy:
on the CPU the slab is never staged, so the share reads 0, and an
untraced run leaves it out."""
from __future__ import annotations


def test_traced_cpu_run_reads_no_staged_transfer(run_tiny):
    run, line = run_tiny("fc1-bulk", seed=2**31 + 32, seconds=0.5,
                         traced=True)
    assert line["correct"]
    got = line["metrics"]["staged_h2d_share.bulk"]
    assert got["value"] == 0.0 and got["unit"] == "%"


def test_untraced_run_leaves_the_share_out(run_tiny):
    run, line = run_tiny("fc1-bulk", seed=2**31 + 33, seconds=0.3)
    assert line["correct"] and run.samples > 0
    assert "staged_h2d_share.bulk" not in line["metrics"]
