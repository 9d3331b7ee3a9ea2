# Port of src/repro/flow/report.py: FlowConfig and EndToEndReport are copied
# verbatim (only the repro imports differ); run_flow trains on a device.
"""End-to-end accuracy-parity study: train -> compile -> map -> serve -> acc.

:func:`run_flow` is the whole paper loop as one artifact (ROADMAP north
star): train a float upper-bound MLP and a binarized MLP on the synthetic
classification task, NullaNet-convert every hidden layer of the binarized
model (flow/convert.py), and run the resulting logic classifier through
all execution backends (flow/classifier.py), measuring

  * **float acc**      — same architecture, ReLU hidden activations
                         (never logic-convertible; the accuracy ceiling);
  * **binarized acc**  — the hard {0,1}-activation model
                         (``classifier.hard_forward``), the function the
                         logic is compiled from;
  * **logic acc**      — per backend (reference / cuda / megakernel /
                         engine).

**Parity methodology** (DESIGN.md §6): with full input enumeration
(``mode='enum'``, every layer fanin <= ``nullanet.ENUM_LIMIT``) the
compiled logic computes *the same Boolean function* as the binarized
model, so ``logic acc == binarized acc`` must hold exactly and all
backends must return bit-identical hidden activations — both are asserted
by the CLI (repro_torch/examples/e2e_nullanet.py) and the flow tests.
With ISF sampling (wide layers) the don't-care assignments may diverge on
patterns unseen during calibration; the report then records the drop
instead of asserting parity.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.nullanet import (BinaryMLPConfig, ENUM_LIMIT,
                                       host_params, mlp_accuracy,
                                       train_binary_mlp)
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET
from repro_torch.data.synthetic import (make_binary_classification,
                                        train_val_split)
from repro_torch.flow.classifier import (BACKENDS, LogicClassifier,
                                         hard_forward, input_bits,
                                         build_classifier)
from repro_torch.kernels.logic_dsp.ops import resolve_device


@dataclass(frozen=True, init=False)
class FlowConfig:
    """One end-to-end run. Defaults keep every layer under ``ENUM_LIMIT``
    fanin so the conversion is exact and parity is provable.

    ``spec`` is the one declarative compilation target
    (:class:`~repro.core.spec.CompileSpec`) the whole run compiles and
    serves against — per-layer conversion AND the engine backend
    (``spec.max_gates`` is the engine's partition budget; per-layer
    programs stay monolithic).  The loose ``n_unit``/``alloc``/
    ``optimize``/``max_gates`` constructor arguments are the deprecated
    pre-spec convention (still accepted, with a ``DeprecationWarning``);
    ``cfg.n_unit`` etc. remain readable as views on the spec.  The
    ``__init__`` is hand-written (not dataclass-generated) so
    ``dataclasses.replace(cfg, spec=...)`` keeps working — the legacy
    arguments are not fields.
    """

    n_features: int = 12
    hidden: tuple[int, ...] = (10, 8)
    n_classes: int = 4
    n_samples: int = 4000
    val_frac: float = 0.25
    noise: float = 0.05
    train_steps: int = 300
    spec: CompileSpec | None = None
    mode: str = "auto"
    seed: int = 0
    backends: tuple[str, ...] = BACKENDS

    def __init__(self, n_features: int = 12, hidden: tuple = (10, 8),
                 n_classes: int = 4, n_samples: int = 4000,
                 val_frac: float = 0.25, noise: float = 0.05,
                 train_steps: int = 300, spec: CompileSpec | None = None,
                 mode: str = "auto", seed: int = 0,
                 backends: tuple = BACKENDS, *, n_unit=_UNSET, alloc=_UNSET,
                 optimize=_UNSET, max_gates=_UNSET):
        spec = resolve_spec(spec, caller="FlowConfig", n_unit=n_unit,
                            alloc=alloc, optimize=optimize,
                            max_gates=max_gates)
        for name, val in (("n_features", n_features), ("hidden", hidden),
                          ("n_classes", n_classes), ("n_samples", n_samples),
                          ("val_frac", val_frac), ("noise", noise),
                          ("train_steps", train_steps), ("spec", spec),
                          ("mode", mode), ("seed", seed),
                          ("backends", backends)):
            object.__setattr__(self, name, val)

    @property
    def exact(self) -> bool:
        """True iff every hidden layer's fanin admits full enumeration."""
        if self.mode == "isf":
            return False
        fanins = (self.n_features, *self.hidden[:-1])
        return all(f <= ENUM_LIMIT for f in fanins)

    def load_data(self) -> tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
        """The run's deterministic (x_train, y_train, x_val, y_val) —
        shared by :func:`run_flow` and the benchmarks so timed inference
        runs on exactly the sample set the reported accuracies used."""
        x, y = make_binary_classification(
            self.n_samples, self.n_features, n_classes=self.n_classes,
            noise=self.noise, seed=self.seed)
        return train_val_split(x, y, val_frac=self.val_frac, seed=self.seed)


# Read-only views on the spec under the pre-spec attribute names
# (``cfg.n_unit`` etc.).  Attached after decoration because the names
# double as the deprecated InitVar constructor arguments above — a
# property in the class body would shadow the InitVar defaults.
for _knob in ("n_unit", "alloc", "optimize", "max_gates"):
    setattr(FlowConfig, _knob,
            property(lambda self, _k=_knob: getattr(self.spec, _k)))
del _knob


@dataclass
class EndToEndReport:
    """Everything the accuracy-parity acceptance criterion needs."""

    float_acc: float
    binarized_acc: float
    logic_acc: dict[str, float]
    parity: bool                    # logic acc == binarized acc, all backends
    bit_identical: bool             # hidden bits equal across backends
    exact_mode: bool                # every layer fully enumerated
    layers: list[dict]              # per-layer gate/step/depth stats
    n_gates: int
    n_steps: int
    sim_cycles: float               # pipelined multi-FFCL simulator estimate
    sim_bound: str
    n_train: int
    n_val: int
    train_s: float
    convert_s: float
    eval_s: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        lines = [
            f"float MLP (relu) val acc     {self.float_acc:.4f}",
            f"binarized MLP val acc        {self.binarized_acc:.4f}",
        ]
        for b, acc in self.logic_acc.items():
            lines.append(f"logic [{b:<9}] val acc      {acc:.4f}  "
                         f"({self.eval_s.get(b, 0.0) * 1e3:.0f} ms)")
        lines.append(
            f"parity: {'EXACT' if self.parity else 'approx'}"
            f" | backends bit-identical: {self.bit_identical}"
            f" | mode: {'enum (exact)' if self.exact_mode else 'isf'}")
        for st in self.layers:
            lines.append(
                f"  {st['name']}: {st['n_inputs']}->{st['n_outputs']} "
                f"{st['n_gates']} gates depth {st['depth']} "
                f"-> {st['n_steps']} steps @ {st['n_unit']} units "
                f"(occ {st['occupancy']:.0%})")
        lines.append(
            f"simulated: {self.sim_cycles:.0f} cycles ({self.sim_bound}-"
            f"bound) for {self.n_val} input vectors; "
            f"train {self.train_s:.1f}s convert {self.convert_s:.1f}s")
        return "\n".join(lines)


def run_flow(cfg: FlowConfig = FlowConfig(), log_every: int = 0,
             device=None, engine=None
             ) -> tuple[EndToEndReport, LogicClassifier]:
    """Run the full train -> FFCL -> serve -> accuracy loop on ``device``
    (CUDA unless told otherwise): both MLPs train there and every backend
    runs there.  ``engine`` serves the ``engine`` backend (default: a
    ``LogicEngine`` over ``cfg.spec`` with capacity 256 on ``device``)."""
    dev = resolve_device(device)
    xt, yt, xv, yv = cfg.load_data()
    mcfg = BinaryMLPConfig(n_features=cfg.n_features, hidden=cfg.hidden,
                           n_classes=cfg.n_classes, seed=cfg.seed)
    n_layers = len(cfg.hidden) + 1

    t0 = time.perf_counter()
    params = train_binary_mlp(mcfg, xt, yt, steps=cfg.train_steps,
                              log_every=log_every, device=dev)
    float_params = train_binary_mlp(mcfg, xt, yt, steps=cfg.train_steps,
                                    log_every=log_every, activation="relu",
                                    device=dev)
    train_s = time.perf_counter() - t0

    float_acc = mlp_accuracy(float_params, mcfg, xv, yv, activation="relu")
    params_np = host_params(params)
    _, logits = hard_forward(params_np, input_bits(xv), n_layers)
    binarized_acc = float((np.argmax(logits, -1) == yv).mean())

    t0 = time.perf_counter()
    clf = build_classifier(params_np, n_layers, xt, cfg.spec, mode=cfg.mode)
    convert_s = time.perf_counter() - t0

    if engine is None and "engine" in cfg.backends:
        from repro_torch.serve import LogicEngine
        engine = LogicEngine(cfg.spec, capacity=256, device=dev)

    logic_acc: dict[str, float] = {}
    eval_s: dict[str, float] = {}
    hidden: dict[str, np.ndarray] = {}
    bits_v = input_bits(xv)
    for backend in cfg.backends:
        t0 = time.perf_counter()
        h = clf.hidden_bits(bits_v, backend=backend, engine=engine,
                            device=dev)
        eval_s[backend] = time.perf_counter() - t0
        hidden[backend] = h
        lg = clf.logits_from_hidden(h)
        logic_acc[backend] = float((np.argmax(lg, -1) == yv).mean())

    ref = next(iter(hidden.values()))
    bit_identical = all((h == ref).all() for h in hidden.values())
    parity = all(acc == binarized_acc for acc in logic_acc.values())

    sim = clf.simulate(n_input_vectors=len(xv))
    stats = clf.layer_stats()
    report = EndToEndReport(
        float_acc=float(float_acc), binarized_acc=binarized_acc,
        logic_acc=logic_acc, parity=parity, bit_identical=bit_identical,
        exact_mode=cfg.exact,
        layers=stats,
        n_gates=sum(s["n_gates"] for s in stats),
        n_steps=sum(s["n_steps"] for s in stats),
        sim_cycles=float(sim.total_cycles), sim_bound=sim.bound,
        n_train=len(xt), n_val=len(xv),
        train_s=train_s, convert_s=convert_s, eval_s=eval_s)
    return report, clf
