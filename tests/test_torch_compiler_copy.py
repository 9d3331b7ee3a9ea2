"""Drift guard for the port's copies of the reference's numpy modules.

The copies are verbatim apart from their import lines (the compiler under
``repro_torch.core`` with the Verilog front end, the simulator, the flow's
layer conversion, the model configuration and the architecture configs,
the front door and its traffic generator, the trainer's resilience
monitors), or verbatim function by function
where the port keeps only part of a module or ports the rest to PyTorch;
the few lines where a copy must differ (a device in place of the TPU's
interpret flag, the calibration record named by device) are listed here
as reference -> port substitutions, so every other line stays guarded.
Both packages must produce the same schedule for the same graph, array by
array: "one scheduler, one schedule" holds in substance even though the
port imports nothing of ``repro``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core.compiler import LogicCompiler as RefCompiler
from repro.core.gate_ir import random_graph as ref_random_graph
from repro.core.espresso import expand_cube as ref_expand_cube
from repro.core.nullanet import layer_to_graph as ref_layer_to_graph
from repro.core.nullanet import neuron_isf as ref_neuron_isf
from repro.core.spec import CompileSpec as RefSpec
from repro_torch.core.compiler import LogicCompiler
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.espresso import expand_cube
from repro_torch.core.nullanet import layer_isfs, layer_to_graph
from repro_torch.core.spec import CompileSpec

ROOT = Path(__file__).resolve().parents[1]
COPIED = [f"core/{m}" for m in (
    "errors", "gate_ir", "levelize", "packing", "opt", "spec", "cost_model",
    "calibrate", "scheduler", "verify", "partition", "optimizer", "compiler",
    "artifact_store", "espresso", "simulator", "verilog", "synth")] + [
    "flow/convert", "models/config", "train/resilience"] + [
    f"configs/{m}" for m in (
        "qwen3_8b", "internlm2_20b", "minicpm_2b", "qwen3_32b",
        "mixtral_8x7b", "grok1_314b", "mamba2_370m", "hubert_xlarge",
        "internvl2_76b", "recurrentgemma_2b")]
# modules the port copies in part: these top-level definitions verbatim
COPIED_DEFS = {
    "data/synthetic": ("make_binary_classification", "train_val_split",
                       "TokenPipeline", "synthetic_tokens"),
    "configs/registry": ("ARCH_IDS", "get_config", "ShapeCell", "SHAPES",
                         "cell_supported", "all_cells"),
    "serve/batcher": ("Request", "RequestBatcher", "SlotTable"),
    "core/nullanet": ("ENUM_LIMIT", "neuron_isf", "neuron_enumerated",
                      "LogicNetwork", "BinaryMLPConfig"),
    "flow/classifier": ("input_bits", "hard_forward"),
    "flow/report": ("FlowConfig", "EndToEndReport"),
    "serve/logic_engine": ("_resolve_cache_spec", "CompiledEntry",
                           "LogicRequest", "_Chunk"),
    "train/sharding": ("_RULES", "_MOE_3D", "_axis", "_shard_if",
                       "leaf_pspec", "param_pspecs", "moment_pspecs",
                       "dp_axes", "batch_pspec", "cache_pspecs"),
    "models/pspec_utils": ("activation_sharding", "active_mesh", "dp_axes",
                           "_resolve"),
    "launch/roofline": ("RooflineTerms", "model_flops"),
}
# copies that differ from the reference in these lines alone (reference
# text -> port text), each definition as a whole; in a module of COPIED
# the rest of the file stays verbatim too
ADAPTED_DEFS = {
    # the registry imports this package's config modules
    ("configs/registry", "_MODULES"): [
        ('"repro.configs." + a', '"repro_torch.configs." + a')],
    # the roofline's rates are the H100 SXM's, and its link term NVLink's
    ("launch/roofline", "PEAK_FLOPS"): [
        ("PEAK_FLOPS = 197e12       # bf16 / chip",
         "PEAK_FLOPS = 989e12       # dense bf16 / H100 SXM")],
    ("launch/roofline", "HBM_BW"): [
        ("HBM_BW = 819e9            # bytes/s / chip",
         "HBM_BW = 3.35e12          # bytes/s / H100 SXM (HBM3)")],
    ("launch/roofline", "_COLLECTIVES"): [   # the HLO parser's comment
        ('\n\n# e.g. "bf16[16,4096,256]{2,1,0}" or "f32[]"', "")],
    ("launch/roofline", "roofline_from_terms"): [
        ("collective_s = coll_bytes / ICI_BW",
         "collective_s = coll_bytes / LINK_BW")],
    # meta tensors stand in for jax.ShapeDtypeStruct
    ("configs/registry", "input_specs"): [
        ('"""ShapeDtypeStruct stand-ins', '"""``meta`` tensor stand-ins'),
        ("""its specs come from ``serve.init_decode_cache`` via
    ``jax.eval_shape`` (no allocation).""",
         """its specs come from ``serve.init_decode_cache`` on
    the ``meta`` device (no allocation)."""),
        ("i32 = jnp.int32", "i32 = torch.int32"),
        ('{"bfloat16": jnp.bfloat16, "float32": jnp.float32}',
         '{"bfloat16": torch.bfloat16, "float32": torch.float32}'),
        ('specs = {"frames": jax.ShapeDtypeStruct(',
         'specs = {"frames": _meta('),
        ('specs["labels"] = jax.ShapeDtypeStruct(',
         'specs["labels"] = _meta('),
        ('"tokens": jax.ShapeDtypeStruct((b, s - n_vis)',
         '"tokens": _meta((b, s - n_vis)'),
        ('"vision": jax.ShapeDtypeStruct(', '"vision": _meta('),
        ('return {"tokens": jax.ShapeDtypeStruct((b, s), i32)}',
         'return {"tokens": _meta((b, s), i32)}'),
        ('return {"tokens": jax.ShapeDtypeStruct((b, 1), i32)}',
         'return {"tokens": _meta((b, 1), i32)}')],
    # EXPAND takes the literals a block at a time with the outcome of one
    # at a time (the same cubes), so VGG16's 2,304-input neurons minimize
    # in a set-up's time
    ("core/espresso", "expand_cube"): [
        ("""    fanins (2304-4608 literals).\"\"\"""",
         """    fanins (2304-4608 literals).

    The literals are taken in blocks with the same outcome as one at a
    time: with every literal of a block dropped in turn, a row's count
    before literal t is its count less its mismatches at the block's
    earlier literals, so the first literal at which some row's running
    sum of mismatches reaches its count is the first one kept; the
    literals before it drop, and the search goes on past it with that
    literal's mismatches added back to the counts. A block that drops
    whole doubles the next (16 up to 1024 literals); one that keeps a
    literal sends the next back to 16.\"\"\""""),
        ("""    mismatch = (X_off != val) & mask          # (n_off, v)
    counts = mismatch.sum(axis=1)             # per off-minterm
    for i in order:
        if not mask[i]:
            continue
        col = mismatch[:, i]
        if np.any(col & (counts == 1)):
            continue                           # would cover an off-minterm
        mask[i] = False
        counts = counts - col
        mismatch[:, i] = False
""", """    # mismatch[i, r]: off-minterm r differs from the cube at literal i
    mismatch = np.ascontiguousarray(X_off.T) != val[:, None]
    mismatch &= mask[:, None]
    # a row with no mismatch left never blocks a drop (its sums stay 0)
    limit = np.add.reduce(mismatch, axis=0, dtype=np.int32)
    np.maximum(limit, 1, out=limit)
    todo = order[mask[order]]
    pos, block = 0, 16
    while pos < todo.size:
        chunk = todo[pos:pos + block]
        pos += chunk.size
        rows = mismatch[chunk]
        total = np.add.reduce(rows, axis=0, dtype=np.int32)
        if (total < limit).all():          # the whole block drops
            mask[chunk] = False
            limit -= total
            block = min(2 * block, 1024)
            continue
        sums = np.cumsum(rows, axis=0, dtype=np.int32)
        kept = np.zeros(chunk.size, dtype=bool)
        at = 0
        while at < chunk.size:
            hit = (sums[at:] >= limit).any(axis=1)
            if not hit[-1]:
                break
            at += int(hit.argmax())
            kept[at] = True
            limit += rows[at]          # a kept literal's mismatches stay
            at += 1
        mask[chunk[~kept]] = False
        limit -= sums[-1]
        block = 16
""")],
    # the layer's ISFs are sampled in one pass (layer_isfs: neuron_isf's
    # arrays, without a deduplication a neuron), under a span
    ("core/nullanet", "layer_to_graph"): [
        ("""      espresso factoring), or a :class:`~repro.core.opt.PassManager`.
    \"\"\"""",
         """      espresso factoring), or a :class:`~repro.core.opt.PassManager`.
    The conversion is the span ``nullanet.layer_to_graph``
    (``repro_torch.obs``), noting its neurons, fanin and seconds.
    \"\"\""""),
        ("""    cube_sets = []
    for j in range(n_neurons):
        if mode == "enum":
            x_on, x_off = neuron_enumerated(W[:, j], float(b[j]))
        else:
            x_on, x_off = neuron_isf(x_bits, W[:, j], float(b[j]))
        cubes = espresso.minimize(x_on, x_off)
        assert espresso.check_cover(cubes, x_on, x_off), \\
            f"minimization broke neuron {j}"
        cube_sets.append(cubes)
    return espresso.sop_to_graph(cube_sets, n_inputs=fanin, name=name,
                                 optimize=optimize)""",
         """    if mode == "enum":
        isfs = (neuron_enumerated(W[:, j], float(b[j]))
                for j in range(n_neurons))
    else:
        isfs = layer_isfs(x_bits, W, b)
    with obs.span("nullanet.layer_to_graph", neurons=n_neurons,
                  fanin=fanin) as sp:
        t0 = time.perf_counter()
        cube_sets = []
        for j, (x_on, x_off) in enumerate(isfs):
            cubes = espresso.minimize(x_on, x_off)
            assert espresso.check_cover(cubes, x_on, x_off), \\
                f"minimization broke neuron {j}"
            cube_sets.append(cubes)
        graph = espresso.sop_to_graph(cube_sets, n_inputs=fanin, name=name,
                                      optimize=optimize)
        sp.note(seconds=time.perf_counter() - t0)
    return graph""")],
    # they take the parameters to the host, so torch tensors on the card
    # convert as they are
    ("core/nullanet", "mlp_to_logic_network"): [
        ("params_np = {k: np.asarray(v) for k, v in params.items()}",
         "params_np = host_params(params)")],
    ("flow/classifier", "build_classifier"): [
        ("alloc=alloc, optimize=optimize)\n",
         "alloc=alloc, optimize=optimize)\n    params = host_params(params)\n")],
    # the port's kernel runs exactly n_unit lanes a step (no sublane
    # padding), so the fit's width regressor takes the unpadded width
    ("core/calibrate", "PAD_UNIT"): [
        ("PAD_UNIT = 8",
         "PAD_UNIT = 1  # the port's kernel pads no lanes "
         "(kernels/logic_dsp/ops.py)")],
    # the measurement helpers run on a torch device (the card unless
    # "cpu"), where the reference picks Pallas interpret mode
    ("core/calibrate", "measure_program_phases"): [
        ("                           interpret: bool = True)",
         "                           device=None)"),
        ("phased_infer_bits(prog, bits, interpret=interpret)          # warm",
         "phased_infer_bits(prog, bits, device=device)          # warm"),
        ("_, phases = phased_infer_bits(prog, bits, interpret=interpret)",
         "_, phases = phased_infer_bits(prog, bits, device=device)")],
    ("core/calibrate", "collect_probes"): [
        ("*, interpret: bool = True)", "*, device=None)"),
        ("phased_infer_bits(prog, bits, interpret=interpret)    # warm",
         "phased_infer_bits(prog, bits, device=device)    # warm"),
        ("_, phases = phased_infer_bits(prog, bits, interpret=interpret)",
         "_, phases = phased_infer_bits(prog, bits, device=device)")],
    # the calibration warm start loads this device's record ("torch-cuda"
    # or "torch-cpu"), never the reference's "default" (a TPU's fit); the
    # cache records that device, and an engine on another refuses it
    ("serve/logic_engine", "ProgramCache"): [
        ("store: ArtifactStore | None = None):",
         "store: ArtifactStore | None = None, device=None):"),
        ("""persisted "default"
        # fit, so a fresh process""",
         """persisted fit for the
        # device its engines run on (``ops.calibration_name``), so a
        # fresh process"""),
        ("        self.store = store\n",
         "        self.store = store\n"
         "        # The device whose calibration record a store-backed cache "
         "loads;\n"
         "        # an engine on another device refuses the cache "
         "(LogicEngine).\n"
         "        # None when neither a store nor a device is named: nothing "
         "in the\n"
         "        # cache then depends on a device.\n"
         "        self.device = None if store is None and device is None "
         "else \\\n"
         "            resolve_device(device)\n"),
        ("store.load_calibration()",
         "store.load_calibration(\n"
         "                    calibration_name(self.device))")],
}
IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)
# ports guarded line by line against their reference module, import
# statements left out, with these device adaptations (reference text ->
# port text): the door's engine takes the door's device, and the executor
# thread that steps it runs under that device and the constructing
# thread's stream (a new thread starts on device 0 and its default stream)
SERVE_COPIES = {
    "serve/traffic": [],
    "serve/frontdoor": [
        ("""      spec / capacity / store: engine construction knobs when ``engine``
        is omitted (``store``""",
         """      spec / capacity / store / device: engine construction knobs when
        ``engine`` is omitted (``device``: where it runs, CUDA unless
        ``"cpu"``; ``store``"""),
        ("dispatch_batch: int = 16):", "dispatch_batch: int = 16, device=None):"),
        ("LogicEngine(spec, capacity=capacity, store=store)\n",
         "LogicEngine(spec, capacity=capacity, store=store, device=device)\n"
         "        # the executor thread that steps the engine takes this "
         "device and\n"
         "        # the constructing thread's stream on it (see _step)\n"
         "        self._stream = current_stream(self.engine.device)\n"),
        ("        finished = self.engine.step()\n",
         "        with device_scope(self.engine.device, self._stream):\n"
         "            finished = self.engine.step()\n")],
}

STREAMS = ("src_a", "src_b", "dst", "opcode", "step_branch", "output_addrs")
MEGA = ("src_a", "src_b", "dst", "opcode", "step_branch", "step_trash",
        "out_addrs", "output_perm")


def _substitute(text: str, subs, where: str) -> str:
    for old, new in subs:
        assert text.count(old) == 1, f"{where}: {old!r} left the reference"
        text = text.replace(old, new)
    return text


def _drop_source_note(text: str) -> str:
    lines = text.splitlines(keepends=True)
    while lines and lines[0].startswith("#"):
        lines.pop(0)
    return "".join(lines)


def _without_imports(text: str) -> list[str]:
    """The module's lines without its top-level import statements (their
    parenthesized continuations included)."""
    out, open_parens = [], 0
    for line in text.splitlines():
        if open_parens or line.startswith(("import ", "from ")):
            open_parens = max(0, open_parens + line.count("(")
                              - line.count(")"))
            continue
        out.append(line)
    return out


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
    port = _drop_source_note(port)
    want = IMPORT.sub(r"\1\2 repro_torch.", ref)
    defs = _top_level_defs(want)
    for (module, defn), subs in ADAPTED_DEFS.items():
        if module == name:
            want = want.replace(defs[defn], _substitute(
                defs[defn], subs, f"{name}.{defn}"))
    assert port.rstrip() == want.rstrip()


@pytest.mark.parametrize("name", sorted(SERVE_COPIES))
def test_serve_port_matches_reference_line_by_line(name):
    ref = (ROOT / "src" / "repro" / f"{name}.py").read_text()
    port = (ROOT / "src" / "repro_torch" / f"{name}.py").read_text()
    want = _without_imports(_substitute(ref, SERVE_COPIES[name], name))
    got = _without_imports(_drop_source_note(port))
    assert got == want


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
    want = _substitute(_top_level_defs(ref)[defn], ADAPTED_DEFS[name, defn],
                       f"{name}.{defn}")
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


@pytest.fixture(scope="module")
def wide_layer():
    """A layer past 2,048 inputs (VGG16's conv layers: 2,304-4,608) and
    the reference's graph of it, synthesized one neuron after another."""
    rng = np.random.default_rng(2100)
    x_bits = rng.integers(0, 2, (48, 2100)).astype(np.uint8)
    x_bits[9] = x_bits[2]
    W = rng.normal(size=(2100, 5)).astype(np.float32)
    b = (0.1 * rng.normal(size=5)).astype(np.float32)
    return x_bits, W, b, ref_layer_to_graph(x_bits, W, b, mode="isf")


def test_layer_to_graph_same_fingerprint_past_2048_inputs(wide_layer):
    """EXPAND by blocks and the layer's ISFs in one pass give the
    reference's graph at VGG widths."""
    x_bits, W, b, ref = wide_layer
    port = layer_to_graph(x_bits, W, b, mode="isf")
    assert port.n_gates == ref.n_gates > 0
    assert port.fingerprint() == ref.fingerprint()


def test_layer_isfs_are_neuron_isf(wide_layer):
    x_bits, W, b, _ = wide_layer
    isfs = list(layer_isfs(x_bits, W, b))
    assert len(isfs) == W.shape[1]
    for j, (x_on, x_off) in enumerate(isfs):
        want_on, want_off = ref_neuron_isf(x_bits, W[:, j], float(b[j]))
        np.testing.assert_array_equal(x_on, want_on)
        np.testing.assert_array_equal(x_off, want_off)


def test_expand_cube_by_blocks_keeps_the_references_literals():
    """Random cubes, off-sets and orders over up to 1,300 literals (the
    blocks grow from 16 to 1,024), with off-rows the cube already matches
    (no mismatch left to drop): the same literals survive."""
    rng = np.random.default_rng(256)
    for trial in range(300):
        v, n = int(rng.integers(1, 1300)), int(rng.integers(0, 90))
        p = rng.uniform(0.05, 0.95)
        X_off = (rng.random((n, v)) < p).astype(np.uint8)
        val = (rng.random(v) < p).astype(np.uint8)
        mask = rng.random(v) < rng.uniform(0.3, 1.0)
        if trial % 4 == 0 and n:
            X_off[0] = np.where(mask, val, X_off[0])
        order = rng.permutation(v)
        want, _ = ref_expand_cube(mask, val, X_off, order)
        got, _ = expand_cube(mask, val, X_off, order)
        np.testing.assert_array_equal(got, want)
