"""The port's Verilog front end, the quickstart flow and the store audit
tool, held against the JAX package.

``repro_torch.core.verilog`` is a verbatim copy (drift-guarded in
``test_torch_compiler_copy.py``); here both packages parse the same text
into the same graph (fingerprint), the round trip and the expression
parser keep their semantics, the quickstart circuit runs through the
port's plain K1 path bit-exactly against the reference's Pallas kernel
(interpret mode), and ``python -m repro_torch.tools.verify_program`` keeps
the reference tool's exit codes.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.scheduler import compile_graph as ref_compile_graph
from repro.core.spec import CompileSpec as RefSpec
from repro.core.verilog import emit_verilog as ref_emit_verilog
from repro.core.verilog import parse_verilog as ref_parse_verilog
from repro.kernels.logic_dsp import logic_infer_bits as ref_logic_infer_bits
from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.compiler import LogicCompiler
from repro_torch.core.gate_ir import OpCode, random_graph
from repro_torch.core.opt import PassManager
from repro_torch.core.scheduler import compile_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.core.synth import optimize
from repro_torch.core.verilog import emit_verilog, parse_verilog
from repro_torch.examples import quickstart
from repro_torch.tools import verify_program

ROOT = Path(__file__).resolve().parents[1]
EXPRESSIONS = """
    // comment
    module m(a, b, c, y, z);
      input a, b, c; output y, z; wire w1;
      and g0 (w1, a, b);
      assign y = ~(w1 ^ c) | (a & 1'b1);
      nor g1 (z, w1, c);
    endmodule
    """
OUT_OF_ORDER = """
    module m(a, b, y);
      input a, b; output y; wire w1, w2;
      and g1 (y, w1, w2);      // uses wires defined later
      not g2 (w1, a);
      or  g3 (w2, a, b);
    endmodule
    """
STREAMS = ("src_a", "src_b", "dst", "opcode", "step_branch", "output_addrs")


def test_verilog_roundtrip(rng):
    for _ in range(5):
        g = random_graph(rng, 6, 60, 4)
        g2 = parse_verilog(emit_verilog(g))
        X = rng.integers(0, 2, (64, 6)).astype(bool)
        assert (g.evaluate(X) == g2.evaluate(X)).all()


def test_verilog_expressions():
    g = parse_verilog(EXPRESSIONS)
    X = ((np.arange(8)[:, None] >> np.arange(3)) & 1).astype(bool)
    a, b, c = X.T
    w1 = a & b
    out = g.evaluate(X)
    assert (out[:, 0] == (~(w1 ^ c) | a)).all()
    assert (out[:, 1] == ~(w1 | c)).all()


@pytest.mark.parametrize("source", ["quickstart", "expressions",
                                    "out_of_order", "emitted"])
def test_parse_verilog_same_graph_as_reference(source):
    if source == "emitted":
        kw = dict(unary_frac=0.2, locality=16)
        text = emit_verilog(random_graph(np.random.default_rng(3), 10, 200,
                                         6, **kw))
        ref_text = ref_emit_verilog(ref_random_graph(
            np.random.default_rng(3), 10, 200, 6, **kw))
        assert text == ref_text
    else:
        text = {"quickstart": quickstart.VERILOG, "expressions": EXPRESSIONS,
                "out_of_order": OUT_OF_ORDER}[source]
    g, ref = parse_verilog(text), ref_parse_verilog(text)
    assert (g.n_inputs, g.n_outputs, g.n_gates) == \
        (ref.n_inputs, ref.n_outputs, ref.n_gates)
    assert g.fingerprint() == ref.fingerprint()
    assert optimize(g).fingerprint() == \
        PassManager.default().run(g).graph.fingerprint()


def test_quickstart_plain_k1_matches_reference_kernel():
    r = quickstart.run(device="cpu")
    graph, prog, x = r["graph"], r["program"], r["x"]
    ref_graph = ref_parse_verilog(quickstart.VERILOG)
    from repro.core.opt import PassManager as RefPassManager
    ref_graph = RefPassManager.default().run(ref_graph).graph
    assert graph.fingerprint() == ref_graph.fingerprint()
    ref_prog = ref_compile_graph(ref_graph, RefSpec(
        n_unit=4, alloc="liveness", optimize="none"))
    for f in STREAMS:
        np.testing.assert_array_equal(getattr(prog, f), getattr(ref_prog, f))
    want = ref_logic_infer_bits(ref_prog, x)          # Pallas, interpret
    np.testing.assert_array_equal(r["out"], np.asarray(want))
    np.testing.assert_array_equal(r["out"], graph.evaluate(x))
    assert r["out"].shape == (quickstart.N_VECTORS, 2)
    assert r["cost"].n_total_pipelined > 0


def test_quickstart_main_prints_the_flow(capsys):
    quickstart.main(device="cpu")
    out = capsys.readouterr().out
    assert "kernel output == direct evaluation == ground truth" in out
    assert "cost model:" in out


# ---------------------------------------------------------------------------
# the store audit tool
# ---------------------------------------------------------------------------

def _store_with_two_entries(root):
    store = ArtifactStore(root)
    keys = []
    for seed in (1, 2):
        g = random_graph(np.random.default_rng(seed), 8, 150, 6,
                         unary_frac=0.2, locality=16)
        keys.append(store.save(LogicCompiler().compile(
            g, CompileSpec(n_unit=8))))
    return store, keys


def _poison(store, key):
    """Re-publish ``key``'s artifact with one gate reading its first
    operand twice: every checksum is valid, the schedule is wrong."""
    art = store.load_key(key)
    p = art.programs[0]
    binary = (p.opcode >= int(OpCode.AND)) & (p.opcode <= int(OpCode.XNOR))
    live = np.argwhere((p.dst != p.trash_addr) & (p.src_a != p.src_b)
                       & binary)
    s, u = map(int, live[-1])
    b = np.array(p.src_b)
    b[s, u] = p.src_a[s, u]
    bad = dataclasses.replace(art, programs=(dataclasses.replace(
        p, src_b=b),))
    store.quarantine(key)
    return store.save(bad)


def test_verify_program_clean_store_exits_0(tmp_path, capsys):
    _, keys = _store_with_two_entries(tmp_path / "s")
    assert verify_program.main(["--store", str(tmp_path / "s"),
                                "--json"]) == 0
    recs = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert sorted(r["key"] for r in recs) == sorted(keys)
    assert all(r["ok"] and not r["diagnostics"] for r in recs)
    assert verify_program.main(["--store", str(tmp_path / "s"),
                                keys[0]]) == 0
    assert "1 entry, 0 failed" in capsys.readouterr().out


@pytest.mark.parametrize("corruption", ["schedule", "bytes"])
@pytest.mark.parametrize("quarantine", [False, True])
def test_verify_program_failed_entry_exits_1(tmp_path, capsys, corruption,
                                             quarantine):
    store, keys = _store_with_two_entries(tmp_path / "s")
    if corruption == "schedule":
        bad = _poison(store, keys[0])
    else:
        bad = keys[0]
        arrays = store.path_of(bad) / "arrays.npz"
        data = bytearray(arrays.read_bytes())
        data[len(data) // 2] ^= 0xFF
        arrays.write_bytes(bytes(data))
    argv = ["--store", str(tmp_path / "s")] + \
        (["--quarantine"] if quarantine else [])
    assert verify_program.main(argv) == 1
    out = capsys.readouterr().out
    assert f"FAIL {bad}" in out and "2 entries, 1 failed" in out
    assert f"OK   {keys[1]}" in out
    # an integrity failure quarantines at the store layer; a schedule
    # failure only when asked
    gone = corruption == "bytes" or quarantine
    assert (bad not in ArtifactStore(tmp_path / "s")) == gone
    assert keys[1] in ArtifactStore(tmp_path / "s")


def test_verify_program_usage_errors_exit_2(tmp_path, capsys):
    _store_with_two_entries(tmp_path / "s")
    assert verify_program.main(["--store", str(tmp_path / "s"),
                                "nope"]) == 2
    assert "no store entry" in capsys.readouterr().err
    assert verify_program.main(["--store", str(tmp_path / "empty")]) == 0
    with pytest.raises(SystemExit) as exc:
        verify_program.main([])                     # --store is required
    assert exc.value.code == 2


def test_verify_program_runs_as_module(tmp_path):
    _store_with_two_entries(tmp_path / "s")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.verify_program",
         "--store", str(tmp_path / "s"), "--json"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 2


def test_same_program_for_parsed_netlist_as_reference():
    """A parsed netlist compiles to array-equal streams in both packages
    (the quickstart's n_unit and allocation)."""
    text = emit_verilog(random_graph(np.random.default_rng(11), 12, 300, 8,
                                     unary_frac=0.2, locality=32))
    g, ref = parse_verilog(text), ref_parse_verilog(text)
    spec = dict(n_unit=4, alloc="liveness", optimize="none")
    p, rp = compile_graph(g, CompileSpec(**spec)), \
        ref_compile_graph(ref, RefSpec(**spec))
    for f in STREAMS:
        np.testing.assert_array_equal(getattr(p, f), getattr(rp, f))
    assert (p.n_addr, p.n_steps) == (rp.n_addr, rp.n_steps)
