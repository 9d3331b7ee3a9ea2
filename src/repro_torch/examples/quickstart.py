"""Quickstart: compile a Boolean netlist onto the time-shared logic fabric.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the paper's §4/§6
flow on a small Verilog module, parse -> logic synthesis -> levelize ->
sub-kernel scheduling -> execution on ``--device`` (K1, the single-program
CUDA kernel, on the card unless told otherwise; the plain PyTorch
executor on the CPU), validated against direct DAG evaluation and the
majority / parity ground truth, plus the analytical cost model's view of
the schedule.
"""
import argparse

import numpy as np

from repro_torch.core.cost_model import CostModel, FfclStats
from repro_torch.core.levelize import levelize
from repro_torch.core.opt import PassManager
from repro_torch.core.scheduler import compile_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.core.verilog import parse_verilog
from repro_torch.kernels.logic_dsp import logic_infer_bits

VERILOG = """
module majority5_and_parity(a, b, c, d, e, maj, par);
  input a, b, c, d, e;
  output maj, par;
  wire ab, ac, ad, ae, bc, bd, be, cd, ce, de;
  and g0 (ab, a, b);  and g1 (ac, a, c);  and g2 (ad, a, d);
  and g3 (ae, a, e);  and g4 (bc, b, c);  and g5 (bd, b, d);
  and g6 (be, b, e);  and g7 (cd, c, d);  and g8 (ce, c, e);
  and g9 (de, d, e);
  // majority-of-5 = OR of all 3-subsets; factored via pair terms
  assign maj = (ab & (c | d | e)) | (ac & (d | e)) | (ad & e)
             | (bc & (d | e)) | (bd & e) | (cd & e);
  assign par = a ^ b ^ c ^ d ^ e;
endmodule
"""
N_VECTORS = 1000


def run(device=None, seed: int = 0) -> dict:
    """The flow on ``device``; raises if the kernel's output differs from
    direct evaluation or from the ground truth.  Returns the parsed and
    synthesized graphs, the program, the inputs, the output and the cost
    model's breakdown."""
    parsed = parse_verilog(VERILOG)
    res = PassManager.default().run(parsed)   # pass-based optimization
    graph = res.graph
    # the declarative compilation target (core/spec.py): optimize="none"
    # because the pass pipeline already ran above
    spec = CompileSpec(n_unit=4, alloc="liveness", optimize="none")
    prog = compile_graph(graph, spec)

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (N_VECTORS, 5)).astype(bool)
    got = logic_infer_bits(prog, x, device=device)
    want = graph.evaluate(x)
    maj = x.sum(axis=1) >= 3
    par = x.sum(axis=1) % 2 == 1
    if not (got == want).all():
        raise RuntimeError("kernel output differs from direct evaluation")
    if not ((got[:, 0] == maj).all() and (got[:, 1] == par).all()):
        raise RuntimeError("kernel output differs from majority / parity")
    breakdown = CostModel().breakdown(FfclStats.from_graph(graph),
                                      spec.n_unit, N_VECTORS)
    return {"parsed": parsed, "graph": graph, "iterations": res.iterations,
            "spec": spec, "program": prog, "x": x, "out": got,
            "cost": breakdown}


def main(device=None) -> None:
    r = run(device)
    graph, prog, spec, b = r["graph"], r["program"], r["spec"], r["cost"]
    print(f"parsed: {r['parsed'].stats()}")
    print(f"synthesized ({r['iterations']} pipeline iters): {graph.stats()}"
          f"  level histogram={list(levelize(graph).histogram())}")
    print(f"scheduled on {spec.n_unit} units: {prog.n_steps} sub-kernel "
          f"steps, {prog.n_addr} buffer rows (paper eq. 23)")
    print("kernel output == direct evaluation == ground truth  "
          f"[{N_VECTORS} vectors]")
    print(f"cost model: {b.n_total_pipelined:.0f} cycles "
          f"(dm={b.n_data_moves:.0f}, compute={b.n_compute:.0f}, "
          f"bound={b.bound})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the program runs: CUDA unless 'cpu'")
    main(ap.parse_args().device)
