"""The port's NullaNet flow (train -> convert -> serve) against the JAX one.

Training is float32 arithmetic in two frameworks, so the forward, the
gradients and one optimizer update are compared with stated tolerances on
identical parameters and inputs (made by numpy from a seed):

* logits, rtol 1e-5: the same float32 ops in the same order, up to the
  summation order of each BLAS matmul;
* gradients of one batch, rtol 1e-4: the backward adds a log-softmax and
  tanh derivatives, each a few float32 roundings more;
* one AdamW update, rtol 1e-6: elementwise, the same algebra in another
  order.

Each also has an atol of a few float32 roundings of the terms that meet
in it (1e-6 for logits and gradients, whose terms are O(1); 1e-9 for the
update, whose step is lr = 2e-3): an entry that cancels to about zero has
no relative precision.

Parameters are never compared after many steps: a straight-through
threshold at ``y ~ 0`` may flip between frameworks and the runs then part.
For the conversion and execution, the reference's parameters go through
``repro_torch.convert.params_from_reference`` into the port's
``build_classifier``; the layer graphs, program streams and hidden bits
must then be identical, on every backend of each package.  A run of the
port's own ``run_flow`` is held to the reference's gates: ``parity`` and
``bit_identical`` in exact mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nullanet import BinaryMLPConfig as RefMLPConfig
from repro.core.nullanet import binary_mlp_forward as ref_forward
from repro.core.nullanet import init_binary_mlp as ref_init
from repro.core.nullanet import mlp_to_logic_network as ref_mlp_to_logic
from repro.core.nullanet import train_binary_mlp as ref_train
from repro.core.spec import CompileSpec as RefSpec
from repro.flow import FlowConfig as RefFlowConfig
from repro.flow import build_classifier as ref_build_classifier
from repro.optim import adamw_init, adamw_update
from repro.serve import LogicEngine as RefEngine
from repro_torch.convert import params_from_reference
from repro_torch.core.nullanet import (BinaryMLPConfig, _adamw, _loss,
                                       binary_mlp_forward, init_binary_mlp,
                                       mlp_accuracy, mlp_to_logic_network,
                                       train_binary_mlp)
from repro_torch.core.spec import CompileSpec
from repro_torch.flow import (BACKENDS, FlowConfig, build_classifier,
                              hard_forward, input_bits, run_flow)
from repro_torch.kernels.logic_dsp import kernel as _k
from repro_torch.serve import LogicEngine

CFG = dict(n_features=20, hidden=(12, 7), n_classes=4, seed=3)
STREAMS = ("src_a", "src_b", "dst", "opcode", "step_branch", "output_addrs")
REF_BACKENDS = ("reference", "pallas", "megakernel", "engine")


def _params():
    """Identical initial parameters: the port's (torch) and the
    reference's (numpy), from the same draws."""
    port = init_binary_mlp(BinaryMLPConfig(**CFG))
    ref = {k: np.asarray(v) for k, v in ref_init(RefMLPConfig(**CFG)).items()}
    return port, ref


def _batch(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (n, CFG["n_features"])).astype(np.float32)
    y = rng.integers(0, CFG["n_classes"], n)
    return x, y


def _ref_loss(p, xb, yb, activation):
    logits = ref_forward(p, xb, len(CFG["hidden"]) + 1,
                         activation=activation)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))


def test_init_draws_the_reference_weights():
    port, ref = _params()
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), ref[k])


@pytest.mark.parametrize("activation", ["sign", "relu"])
def test_forward_logits_match(activation):
    port, ref = _params()
    x, _ = _batch()
    n_layers = len(CFG["hidden"]) + 1
    got, acts = binary_mlp_forward(port, torch.from_numpy(x), n_layers,
                                   return_activations=True,
                                   activation=activation)
    want, ref_acts = ref_forward({k: jnp.asarray(v) for k, v in ref.items()},
                                 jnp.asarray(x), n_layers,
                                 return_activations=True,
                                 activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for a, ra in zip(acts[1:], ref_acts[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        binary_mlp_forward(port, torch.from_numpy(x), n_layers,
                           activation="tanh")


@pytest.mark.parametrize("activation", ["sign", "relu"])
def test_gradients_of_one_batch_match(activation):
    port, ref = _params()
    x, y = _batch(1)
    n_layers = len(CFG["hidden"]) + 1
    p = {k: v.clone().requires_grad_() for k, v in port.items()}
    loss = _loss(p, torch.from_numpy(x), torch.from_numpy(y), n_layers,
                 activation)
    loss.backward()
    ref_p = {k: jnp.asarray(v) for k, v in ref.items()}
    ref_l, ref_g = jax.value_and_grad(_ref_loss)(
        ref_p, jnp.asarray(x), jnp.asarray(y, jnp.int32), activation)
    np.testing.assert_allclose(loss.item(), float(ref_l), rtol=1e-5)
    for k in ref:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(ref_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_adamw_updates_match():
    """The port's optimizer is the reference's adamw_update with b2 0.95
    and no weight decay, given identical parameters and gradients."""
    port, ref = _params()
    rng = np.random.default_rng(2)
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in ref.items()}
    grads["b0"][:3] = 0.0                     # a coordinate with no signal
    p = {k: v.clone().requires_grad_() for k, v in port.items()}
    opt = _adamw(list(p.values()), lr=2e-3)
    for _ in range(2):                        # two steps: bias correction
        for k, v in p.items():
            v.grad = torch.from_numpy(grads[k].copy())
        opt.step()
    ref_p = {k: jnp.asarray(v) for k, v in ref.items()}
    state = adamw_init(ref_p)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    for _ in range(2):
        ref_p, state = adamw_update(jg, state, ref_p, lr=2e-3,
                                    weight_decay=0.0)
    for k in ref:
        np.testing.assert_allclose(p[k].detach().numpy(),
                                   np.asarray(ref_p[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_train_binary_mlp_learns_on_cpu():
    """Training runs on the named device and learns the task (the
    reference's own gate: accuracy well above chance)."""
    cfg = RefFlowConfig(n_features=12, hidden=(10, 8), n_classes=4,
                        n_samples=600, train_steps=60, seed=0)
    xt, yt, xv, yv = cfg.load_data()
    mcfg = BinaryMLPConfig(n_features=12, hidden=(10, 8), n_classes=4)
    params = train_binary_mlp(mcfg, xt, yt, steps=60, device="cpu")
    assert all(v.device.type == "cpu" and not v.requires_grad
               for v in params.values())
    assert mlp_accuracy(params, mcfg, xv, yv) > 0.6


def _ref_trained(mode):
    """Reference-trained parameters of a small MLP, and its data: fanin
    12 (enumerated) or 20 (ISF-sampled) in the first layer."""
    n_features = 12 if mode == "enum" else 20
    cfg = RefFlowConfig(n_features=n_features, hidden=(10, 6), n_classes=3,
                        n_samples=300, train_steps=40, seed=1)
    xt, yt, xv, _ = cfg.load_data()
    params = ref_train(RefMLPConfig(n_features=n_features, hidden=(10, 6),
                                    n_classes=3, seed=1), xt, yt, steps=40)
    return {k: np.asarray(v) for k, v in params.items()}, xt, xv


@pytest.mark.parametrize("mode", ["enum", "isf"])
def test_classifier_matches_reference_with_carried_params(mode):
    params, xt, xv = _ref_trained(mode)
    ref = ref_build_classifier(params, 3, xt, RefSpec(n_unit=16))
    clf = build_classifier(params_from_reference(params), 3, xt,
                           CompileSpec(n_unit=16))
    assert len(clf.layers) == len(ref.layers) == 2
    for layer, rl in zip(clf.layers, ref.layers):
        assert layer.graph.fingerprint() == rl.graph.fingerprint()
        for f in STREAMS:
            np.testing.assert_array_equal(getattr(layer.program, f),
                                          getattr(rl.program, f))
        assert (layer.program.n_addr, layer.program.n_steps) == \
            (rl.program.n_addr, rl.program.n_steps)
    for f in ("src_a", "src_b", "dst", "opcode", "step_branch",
              "out_addrs"):
        np.testing.assert_array_equal(getattr(clf.megaprogram, f),
                                      getattr(ref.megaprogram, f))
    bits = input_bits(xv)
    acts, _ = hard_forward(params, bits, 3)
    want = np.asarray(ref.hidden_bits(bits, backend="reference"))
    if mode == "enum":
        np.testing.assert_array_equal(want, acts[-1].astype(bool))
    for b in REF_BACKENDS[1:]:
        np.testing.assert_array_equal(
            np.asarray(ref.hidden_bits(bits, backend=b)), want, err_msg=b)
    for b in BACKENDS:
        np.testing.assert_array_equal(
            clf.hidden_bits(bits, backend=b, device="cpu"), want, err_msg=b)
    np.testing.assert_array_equal(clf.predict(xv, device="cpu"),
                                  ref.predict(xv))
    assert clf.layer_stats() == ref.layer_stats()
    assert clf.simulate(len(xv)).total_cycles == \
        ref.simulate(len(xv)).total_cycles


def _as_form(params, form):
    """Carried parameters as numpy arrays, or as the float32 tensors
    ``train_binary_mlp`` returns."""
    params = params_from_reference(params)
    if form == "tensor":
        return {k: torch.from_numpy(v) for k, v in params.items()}
    return params


@pytest.mark.parametrize("form", ["numpy", "tensor"])
@pytest.mark.parametrize("mode", ["enum", "isf"])
def test_mlp_to_logic_network_matches_reference(mode, form):
    """The graph-only conversion and build_classifier give the reference's
    graphs, head and predictions from carried parameters, numpy or torch
    alike."""
    params, xt, xv = _ref_trained(mode)
    cfg = BinaryMLPConfig(n_features=xt.shape[1], hidden=(10, 6),
                          n_classes=3, seed=1)
    ref = ref_mlp_to_logic(params, RefMLPConfig(
        n_features=xt.shape[1], hidden=(10, 6), n_classes=3, seed=1), xt)
    net = mlp_to_logic_network(_as_form(params, form), cfg, xt)
    assert [g.fingerprint() for g in net.graphs] == \
        [g.fingerprint() for g in ref.graphs]
    np.testing.assert_array_equal(net.w_out, ref.w_out)
    np.testing.assert_array_equal(net.b_out, ref.b_out)
    bits = input_bits(xv)
    np.testing.assert_array_equal(net.predict(bits), ref.predict(bits))
    clf = build_classifier(_as_form(params, form), 3, xt,
                           CompileSpec(n_unit=16))
    assert [c.graph.fingerprint() for c in clf.layers] == \
        [g.fingerprint() for g in ref.graphs]


def test_unknown_backend_raises():
    params, xt, _ = _ref_trained("enum")
    clf = build_classifier(params_from_reference(params), 3, xt,
                           CompileSpec(n_unit=16))
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        clf.hidden_bits(input_bits(xt), backend="pallas", device="cpu")


def test_classifier_engine_partitioned_matches(rng):
    """Engine serving with a partition budget (pipelined multi-program
    sequence over the composed stack) stays bit-identical, as in the
    reference's test_flow.py."""
    params = {
        "w0": rng.normal(size=(6, 5)).astype(np.float32),
        "b0": rng.normal(size=5).astype(np.float32),
        "w1": rng.normal(size=(5, 2)).astype(np.float32),
        "b1": np.zeros(2, np.float32),
    }
    x = rng.integers(0, 2, (40, 6)).astype(np.uint8)
    clf = build_classifier(params, 2, x, CompileSpec(n_unit=8))
    bits = input_bits(x)
    ref = clf.hidden_bits(bits, backend="reference", device="cpu")
    budget = max(2, clf.stacked_graph.n_gates // 3)
    eng = LogicEngine(CompileSpec(n_unit=8, max_gates=budget), capacity=64,
                      device="cpu")
    got = clf.hidden_bits(bits, backend="engine", engine=eng)
    assert (got == ref).all()
    entry = eng.cache.get(clf.stacked_graph, eng.spec)
    assert len(entry.programs) > 1     # the budget actually partitioned
    assert eng.cache.misses == 1       # no phantom raw compile
    # the reference's engine on the same composed graph agrees
    ref_eng = RefEngine(RefSpec(n_unit=8, max_gates=budget), capacity=64)
    rclf = ref_build_classifier(params, 2, x, RefSpec(n_unit=8))
    np.testing.assert_array_equal(
        rclf.hidden_bits(bits, backend="engine", engine=ref_eng), got)


def test_run_flow_exact_parity_on_cpu():
    """The acceptance criterion, small: logic acc == binarized acc exactly,
    all four backends bit-identical, flow stats populated; no kernel
    launches on the CPU."""
    cfg = FlowConfig(n_features=8, hidden=(6, 5), n_classes=3,
                     n_samples=700, train_steps=60,
                     spec=CompileSpec(n_unit=16))
    assert cfg.exact and cfg.backends == BACKENDS
    before = _k.launch_count()
    report, clf = run_flow(cfg, device="cpu")
    assert _k.launch_count() == before
    assert report.parity and report.bit_identical and report.exact_mode
    assert set(report.logic_acc) == set(BACKENDS)
    assert all(acc == report.binarized_acc
               for acc in report.logic_acc.values())
    assert len(report.layers) == 2
    assert report.n_gates == sum(c.program.n_gates for c in clf.layers)
    assert report.sim_cycles > 0
    assert (report.n_train, report.n_val) == (525, 175)
    assert "parity: EXACT" in report.summary()


def test_flow_config_matches_reference():
    """FlowConfig's defaults, spec views, exactness and data are the
    reference's."""
    cfg, ref = FlowConfig(), RefFlowConfig()
    assert (cfg.n_features, cfg.hidden, cfg.n_classes, cfg.n_samples,
            cfg.val_frac, cfg.noise, cfg.train_steps, cfg.mode) == \
        (ref.n_features, ref.hidden, ref.n_classes, ref.n_samples,
         ref.val_frac, ref.noise, ref.train_steps, ref.mode)
    assert cfg.spec.to_dict() == ref.spec.to_dict()
    assert cfg.exact and ref.exact
    assert cfg.n_unit == ref.n_unit and cfg.max_gates == ref.max_gates
    isf = FlowConfig(n_features=400, hidden=(120, 84), n_classes=10)
    assert not isf.exact
    for a, b in zip(cfg.load_data(), ref.load_data()):
        np.testing.assert_array_equal(a, b)
