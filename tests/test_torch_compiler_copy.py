"""Drift guard for the port's copies of the reference's numpy modules.

The copies are verbatim apart from their import lines (the compiler under
``repro_torch.core``, the simulator, the flow's layer conversion), or
verbatim function by function where the port keeps only part of a module
or ports the rest to PyTorch.  Both packages must produce the same
schedule for the same graph, array by array: "one scheduler, one
schedule" holds in substance even though the port imports nothing of
``repro``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core.compiler import LogicCompiler as RefCompiler
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.nullanet import layer_to_graph as ref_layer_to_graph
from repro.core.spec import CompileSpec as RefSpec
from repro_torch.core.compiler import LogicCompiler
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.nullanet import layer_to_graph
from repro_torch.core.spec import CompileSpec

ROOT = Path(__file__).resolve().parents[1]
COPIED = [f"core/{m}" for m in (
    "errors", "gate_ir", "levelize", "packing", "opt", "spec", "cost_model",
    "calibrate", "scheduler", "verify", "partition", "optimizer", "compiler",
    "artifact_store", "espresso", "simulator")] + ["flow/convert"]
# modules the port copies in part: these top-level definitions verbatim
COPIED_DEFS = {
    "data/synthetic": ("make_binary_classification", "train_val_split"),
    "core/nullanet": ("ENUM_LIMIT", "neuron_isf", "neuron_enumerated",
                      "layer_to_graph", "LogicNetwork", "BinaryMLPConfig"),
    "flow/classifier": ("input_bits", "hard_forward"),
    "flow/report": ("FlowConfig", "EndToEndReport"),
}
# partial copies that differ from the reference in these lines alone
# (reference text -> port text): they take the parameters to the host, so
# torch tensors on the card convert as they are
ADAPTED_DEFS = {
    ("core/nullanet", "mlp_to_logic_network"): [
        ("params_np = {k: np.asarray(v) for k, v in params.items()}",
         "params_np = host_params(params)")],
    ("flow/classifier", "build_classifier"): [
        ("alloc=alloc, optimize=optimize)\n",
         "alloc=alloc, optimize=optimize)\n    params = host_params(params)\n")],
}
IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)
# calibrate's measurement helpers drive the phase-split kernel path, which
# the port does not have yet
LEFT_OUT = {"core/calibrate": ("def measure_program_phases(",
                               "def collect_probes(")}

STREAMS = ("src_a", "src_b", "dst", "opcode", "step_branch", "output_addrs")
MEGA = ("src_a", "src_b", "dst", "opcode", "step_branch", "step_trash",
        "out_addrs", "output_perm")


def _strip_functions(text, starts):
    for start in starts:
        a = text.index(start)
        nxt = re.search(r"^def |^class ", text[a + 1:], re.M)
        b = len(text) if nxt is None else a + 1 + nxt.start()
        text = text[:a] + text[b:]
    return text


def _top_level_defs(text: str) -> dict[str, str]:
    """Each top-level def, class (with its decorators) or assignment of a
    module, by name, with its source text up to the next one."""
    starts = [m for m in re.finditer(
        r"^(?:@[^\n]*\n)*(?:def |class )?([A-Za-z_]\w*)\b", text, re.M)
        if not text[m.start():].startswith(("from ", "import "))]
    out = {}
    for m, nxt in zip(starts, starts[1:] + [None]):
        end = len(text) if nxt is None else nxt.start()
        out.setdefault(m.group(1), text[m.start():end].rstrip())
    return out


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_verbatim_but_for_imports(name):
    ref = (ROOT / "src" / "repro" / f"{name}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / f"{name}.py").read_text()
    lines = port.splitlines(keepends=True)
    while lines and lines[0].startswith("#"):       # the source note
        lines.pop(0)
    port = "".join(lines)
    want = IMPORT.sub(r"\1\2 repro_torch.", ref)
    want = _strip_functions(want, LEFT_OUT.get(name, ()))
    assert port.rstrip() == want.rstrip()


@pytest.mark.parametrize("name,defs", sorted(COPIED_DEFS.items()))
def test_partial_copy_is_verbatim_but_for_imports(name, defs):
    ref = IMPORT.sub(r"\1\2 repro_torch.",
                     (ROOT / "src" / "repro" / f"{name}.py").read_text())
    port = (ROOT / "src" / "repro_torch" / f"{name}.py").read_text()
    want, got = _top_level_defs(ref), _top_level_defs(port)
    for d in defs:
        assert d in got, f"{name}: {d} is missing"
        assert got[d] == want[d], f"{name}: {d} differs from the reference"


@pytest.mark.parametrize("name,defn", sorted(ADAPTED_DEFS))
def test_adapted_copy_differs_only_in_its_named_lines(name, defn):
    ref = IMPORT.sub(r"\1\2 repro_torch.",
                     (ROOT / "src" / "repro" / f"{name}.py").read_text())
    port = (ROOT / "src" / "repro_torch" / f"{name}.py").read_text()
    want = _top_level_defs(ref)[defn]
    for old, new in ADAPTED_DEFS[name, defn]:
        assert want.count(old) == 1, f"{name}: {old!r} left the reference"
        want = want.replace(old, new)
    assert _top_level_defs(port)[defn] == want


def _pair(seed, n_inputs=10, n_gates=260, n_outputs=8):
    """The same random graph built by each package from the same seed."""
    kw = dict(unary_frac=0.2, locality=16)
    ref = ref_random_graph(np.random.default_rng(seed), n_inputs, n_gates,
                           n_outputs, **kw)
    port = random_graph(np.random.default_rng(seed), n_inputs, n_gates,
                        n_outputs, **kw)
    return ref, port


def _assert_same_artifact(ref_art, art):
    assert art.graph.fingerprint() == ref_art.graph.fingerprint()
    assert art.mode == ref_art.mode
    np.testing.assert_array_equal(art.output_perm, ref_art.output_perm)
    assert len(art.programs) == len(ref_art.programs)
    for rp, p in zip(ref_art.programs, art.programs):
        for f in STREAMS:
            np.testing.assert_array_equal(getattr(p, f), getattr(rp, f))
        assert (p.n_addr, p.trash_addr, p.n_steps, p.n_unit) == \
            (rp.n_addr, rp.trash_addr, rp.n_steps, rp.n_unit)
    rm, m = ref_art.megaprogram(), art.megaprogram()
    for f in MEGA:
        np.testing.assert_array_equal(getattr(m, f), getattr(rm, f))
    assert m.stage_meta == rm.stage_meta
    assert (m.n_addr, m.n_unit, m.mode) == (rm.n_addr, rm.n_unit, rm.mode)


@pytest.mark.parametrize("max_gates", [None, 120])
@pytest.mark.parametrize("optimize", ["default", "none"])
@pytest.mark.parametrize("alloc", ["direct", "liveness"])
@pytest.mark.parametrize("n_unit", [8, 64])
def test_same_schedule_as_reference(n_unit, alloc, optimize, max_gates):
    ref_g, g = _pair(seed=n_unit + len(alloc))
    assert g.fingerprint() == ref_g.fingerprint()
    kw = dict(n_unit=n_unit, alloc=alloc, optimize=optimize,
              max_gates=max_gates)
    ref_art = RefCompiler().compile(ref_g, RefSpec(**kw))
    art = LogicCompiler().compile(g, CompileSpec(**kw))
    if max_gates is not None and optimize == "none":
        assert art.partitioned
    _assert_same_artifact(ref_art, art)


def test_same_auto_n_unit_pick():
    ref_g, g = _pair(seed=5)
    ref_art = RefCompiler().compile(ref_g, RefSpec(n_unit="auto"))
    art = LogicCompiler().compile(g, CompileSpec(n_unit="auto"))
    assert art.spec.n_unit == ref_art.spec.n_unit
    _assert_same_artifact(ref_art, art)


def test_layer_to_graph_same_fingerprint():
    """NullaNet synthesis (ISF sampling -> espresso -> gates) agrees at
    fanin 24 with 12 neurons."""
    rng = np.random.default_rng(24)
    x_bits = rng.integers(0, 2, (96, 24)).astype(np.uint8)
    W = rng.normal(size=(24, 12)).astype(np.float32)
    b = (0.1 * rng.normal(size=12)).astype(np.float32)
    ref = ref_layer_to_graph(x_bits, W, b, mode="isf", name="fc")
    port = layer_to_graph(x_bits, W, b, mode="isf", name="fc")
    assert port.n_gates > 0
    assert port.fingerprint() == ref.fingerprint()
