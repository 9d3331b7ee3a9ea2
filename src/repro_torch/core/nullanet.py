# Port of src/repro/core/nullanet.py.  The training half (_ste_sign01 to
# mlp_accuracy) is written in PyTorch; the numpy half (ENUM_LIMIT,
# neuron_isf, neuron_enumerated, layer_to_graph) and LogicNetwork are
# copied verbatim, only the repro imports differ.  mlp_to_logic_network is
# the reference's but for one line: it takes the parameters to the host
# with host_params, so the tensors train_binary_mlp returns on the card
# convert as they are.  layer_to_graph samples every neuron's ISF through
# layer_isfs (the same arrays) and records its span.
"""NullaNet flow (paper §7): binarized NN -> per-neuron Boolean functions.

Pipeline (faithful to [Nazemi et al. 2019] / NullaNet Tiny as summarized in
the paper): train a DNN with binary activations; per neuron, form a Boolean
specification either by *input enumeration* (fanin <= ``ENUM_LIMIT``) or as
an *incompletely specified function* (ISF) sampled on the training set; run
two-level minimization; factor into 2-input gates -> LogicGraph -> the FFCL
compiler (scheduler.py). First/last layers stay full-precision (paper §8.3).

The parameters are a dict of float32 tensors ``{"w{i}", "b{i}"}`` with
``w{i}`` of shape (fin, fout), the reference's layout, so the same draws
and the same dict cross between the packages
(``repro_torch.convert.params_from_reference``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import espresso
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.kernels.logic_dsp.ops import resolve_device

ENUM_LIMIT = 14  # paper §7.1: enumeration applicable to <= ~14 inputs


# ---------------------------------------------------------------------------
# Binarized MLP (training substrate)
# ---------------------------------------------------------------------------

def _ste_sign01(y: torch.Tensor) -> torch.Tensor:
    """Binary {0,1} activation with tanh straight-through gradient."""
    soft = 0.5 * (torch.tanh(y) + 1.0)
    hard = (y >= 0).to(torch.float32)
    return soft + (hard - soft).detach()


@dataclass(frozen=True)
class BinaryMLPConfig:
    n_features: int
    hidden: tuple[int, ...]
    n_classes: int
    seed: int = 0


def init_binary_mlp(cfg: BinaryMLPConfig) -> dict:
    """float32 CPU tensors from the reference's numpy draws: the same seed
    gives the same initial weights in both packages."""
    rng = np.random.default_rng(cfg.seed)
    sizes = [cfg.n_features, *cfg.hidden, cfg.n_classes]
    params = {}
    for i, (fin, fout) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.as_tensor(
            rng.normal(0, (2.0 / fin) ** 0.5, size=(fin, fout)),
            dtype=torch.float32)
        params[f"b{i}"] = torch.zeros((fout,), dtype=torch.float32)
    return params


def binary_mlp_forward(params: dict, x01: torch.Tensor, n_layers: int,
                       return_activations: bool = False,
                       activation: str = "sign"):
    """x01: {0,1} features. Hidden activations binarized; last layer linear.

    ``activation='relu'`` swaps the binarized hidden activations for ReLU
    (full-precision) — the float upper-bound baseline of the end-to-end
    accuracy-parity study (flow/report.py); it is never FFCL-convertible.
    """
    if activation not in ("sign", "relu"):
        raise ValueError(f"unknown activation {activation!r}; "
                         "use 'sign' or 'relu'")
    acts = [x01]
    h = 2.0 * x01.to(torch.float32) - 1.0   # +-1 encoding into the matmul
    for i in range(n_layers - 1):
        y = h @ params[f"w{i}"] + params[f"b{i}"]
        if activation == "relu":
            acts.append(torch.relu(y))
            h = acts[-1]
        else:
            a01 = _ste_sign01(y)
            acts.append(a01)
            h = 2.0 * a01 - 1.0
    logits = h @ params[f"w{n_layers - 1}"] + params[f"b{n_layers - 1}"]
    if return_activations:
        return logits, acts
    return logits


def _loss(params: dict, xb: torch.Tensor, yb: torch.Tensor, n_layers: int,
          activation: str = "sign") -> torch.Tensor:
    """Mean cross-entropy of the forward's logits against labels ``yb``."""
    logits = binary_mlp_forward(params, xb, n_layers, activation=activation)
    return F.cross_entropy(logits, yb)


def _adamw(params, lr: float) -> torch.optim.AdamW:
    """The reference's ``adamw_update`` as ``train_binary_mlp`` calls it
    (src/repro/optim/adamw.py): b1 0.9, b2 0.95, eps 1e-8 added to the
    bias-corrected root, no weight decay.  PyTorch's AdamW computes the
    same update; its default b2 of 0.999 would not."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.0)


def train_binary_mlp(cfg: BinaryMLPConfig, x: np.ndarray, y: np.ndarray,
                     steps: int = 300, batch: int = 256, lr: float = 2e-3,
                     log_every: int = 0, activation: str = "sign",
                     device=None) -> dict:
    """Train on ``device`` (CUDA unless told otherwise); returns the
    parameters as detached float32 tensors on that device.  Batch indices
    come from ``np.random.default_rng(cfg.seed + 1)``, as in the
    reference."""
    dev = resolve_device(device)
    n_layers = len(cfg.hidden) + 1
    params = {k: v.to(dev).requires_grad_()
              for k, v in init_binary_mlp(cfg).items()}
    opt = _adamw(list(params.values()), lr)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.int64), device=dev)

    rng = np.random.default_rng(cfg.seed + 1)
    for t in range(steps):
        idx = torch.as_tensor(rng.integers(0, x.shape[0], size=batch),
                              device=dev)
        loss = _loss(params, x[idx], y[idx], n_layers, activation)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and t % log_every == 0:
            print(f"step {t}: loss {float(loss):.4f}")
    return {k: v.detach() for k, v in params.items()}


def mlp_accuracy(params: dict, cfg: BinaryMLPConfig, x: np.ndarray,
                 y: np.ndarray, activation: str = "sign") -> float:
    """Accuracy of the (STE float32) forward, on the parameters' device."""
    n_layers = len(cfg.hidden) + 1
    dev = params["w0"].device
    with torch.no_grad():
        logits = binary_mlp_forward(
            params, torch.as_tensor(np.asarray(x, np.float32), device=dev),
            n_layers, activation=activation)
        pred = torch.argmax(logits, -1).cpu().numpy()
    return float(np.mean(pred == np.asarray(y)))


def host_params(params: dict) -> dict:
    """The parameters as numpy arrays on the host: torch tensors on any
    device (``train_binary_mlp``'s result) or anything ``np.asarray``
    takes.  The conversion side (numpy) reads them in this form."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Boolean specification extraction
# ---------------------------------------------------------------------------

def neuron_isf(x_bits: np.ndarray, w: np.ndarray, b: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """ISF of one neuron sampled on observed inputs (paper §7.1).

    x_bits: (N, fanin) {0,1}. Neuron fires iff (2x-1)@w + b >= 0.
    Returns deduplicated (X_on, X_off) minterm arrays.
    """
    x_bits = np.asarray(x_bits, dtype=np.uint8)
    acts = ((2.0 * x_bits - 1.0) @ np.asarray(w) + b) >= 0
    pats, idx = np.unique(x_bits, axis=0, return_index=True)
    out = acts[idx]
    return pats[out], pats[~out]


def neuron_enumerated(w: np.ndarray, b: float) -> tuple[np.ndarray, np.ndarray]:
    """Complete truth table by input enumeration (fanin <= ENUM_LIMIT)."""
    fanin = len(w)
    if fanin > ENUM_LIMIT:
        raise ValueError(f"enumeration limited to {ENUM_LIMIT} inputs")
    pats = ((np.arange(2 ** fanin)[:, None] >>
             np.arange(fanin)[None, :]) & 1).astype(np.uint8)
    acts = ((2.0 * pats - 1.0) @ np.asarray(w) + b) >= 0
    return pats[acts], pats[~acts]


def layer_isfs(x_bits: np.ndarray, W: np.ndarray, b: np.ndarray):
    """Each neuron's ISF in neuron order: ``neuron_isf(x_bits, W[:, j],
    b[j])`` for every column ``j``, with the patterns' +-1 form and their
    deduplication, which no neuron changes, computed once for the layer
    (at VGG16 conv8's 400 x 2,304 patterns, 512 neurons: 1 s against 37 s
    a neuron at a time)."""
    x_bits = np.asarray(x_bits, dtype=np.uint8)
    pm1 = 2.0 * x_bits - 1.0
    pats, idx = np.unique(x_bits, axis=0, return_index=True)
    for j in range(W.shape[1]):
        acts = (pm1 @ np.asarray(W[:, j]) + float(b[j])) >= 0
        out = acts[idx]
        yield pats[out], pats[~out]


def layer_to_graph(x_bits: np.ndarray, W: np.ndarray, b: np.ndarray,
                   mode: str = "auto", name: str = "layer",
                   optimize="default") -> LogicGraph:
    """Convert one binarized layer (all neurons, shared inputs) to a graph.

    mode: 'isf' | 'enum' | 'auto' (enum when fanin <= ENUM_LIMIT).
    optimize: gate-level optimization of the factored graph —
      ``"default"`` (the core/opt.py default pipeline), ``"none"`` (raw
      espresso factoring), or a :class:`~repro.core.opt.PassManager`.
    The conversion is the span ``nullanet.layer_to_graph``
    (``repro_torch.obs``), noting its neurons, fanin and seconds.
    """
    fanin, n_neurons = W.shape
    if mode == "auto":
        mode = "enum" if fanin <= ENUM_LIMIT else "isf"
    if mode == "enum":
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
            assert espresso.check_cover(cubes, x_on, x_off), \
                f"minimization broke neuron {j}"
            cube_sets.append(cubes)
        graph = espresso.sop_to_graph(cube_sets, n_inputs=fanin, name=name,
                                      optimize=optimize)
        sp.note(seconds=time.perf_counter() - t0)
    return graph


# ---------------------------------------------------------------------------
# End-to-end logic network
# ---------------------------------------------------------------------------

@dataclass
class LogicNetwork:
    """Hidden layers as FFCL graphs + full-precision output head."""

    graphs: list[LogicGraph]
    w_out: np.ndarray
    b_out: np.ndarray

    def predict(self, x_bits: np.ndarray, executor=None) -> np.ndarray:
        """executor(graph, bits)->bits; defaults to LogicGraph.evaluate."""
        h = np.asarray(x_bits, dtype=np.uint8)
        for g in self.graphs:
            run = executor or (lambda gr, xb: gr.evaluate(xb))
            h = run(g, h.astype(bool)).astype(np.uint8)
        logits = (2.0 * h - 1.0) @ self.w_out + self.b_out
        return np.argmax(logits, axis=-1)


def mlp_to_logic_network(params: dict, cfg: BinaryMLPConfig, x: np.ndarray,
                         mode: str = "auto") -> LogicNetwork:
    """Full NullaNet conversion of the hidden stack of a trained MLP.

    Thin wrapper over the flow conversion path (flow/convert.py, the
    single conversion code path): calibration activations come from the
    float64 hard forward — not the STE float32 training forward — so the
    ISF care-sets sample exactly the Boolean function the logic must
    reproduce (DESIGN.md §6.2). Graph-only (callers schedule at their own
    ``n_unit``); the flow's :class:`LogicClassifier` is the compiled form.
    """
    from repro_torch.flow.classifier import hard_forward, input_bits  # no cycle
    from repro_torch.flow.convert import layer_graph
    n_layers = len(cfg.hidden) + 1
    params_np = host_params(params)
    acts, _ = hard_forward(params_np, input_bits(x), n_layers)
    graphs = [layer_graph(params_np[f"w{i}"], params_np[f"b{i}"], acts[i],
                          mode=mode, name=f"layer{i}")
              for i in range(n_layers - 1)]
    return LogicNetwork(graphs=graphs,
                        w_out=params_np[f"w{n_layers - 1}"],
                        b_out=params_np[f"b{n_layers - 1}"])
