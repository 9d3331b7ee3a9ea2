"""The runner's pack-kernel share in a traced run of the tiny copy: on
the CPU the plain pack and unpack run, so the share reads 0, and an
untraced run leaves it out."""
from __future__ import annotations


def test_traced_cpu_run_reads_no_pack_kernel(run_tiny):
    run, line = run_tiny("fc1-bulk", seed=2**31 + 34, seconds=0.5,
                         traced=True)
    assert line["correct"]
    got = line["metrics"]["pack_kernel_share.bulk"]
    assert got["value"] == 0.0 and got["unit"] == "%"


def test_untraced_run_leaves_the_pack_kernel_share_out(run_tiny):
    run, line = run_tiny("fc1-bulk", seed=2**31 + 35, seconds=0.3)
    assert line["correct"] and run.samples > 0
    assert "pack_kernel_share.bulk" not in line["metrics"]
