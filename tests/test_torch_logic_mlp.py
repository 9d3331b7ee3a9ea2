"""The logic-FFN swap (paper §7.1 inside a transformer block), held against
the JAX package.

The same seeded inputs and parameters go through the reference's
``models/logic_mlp.py`` and the port's: ``binary_ffn`` at 1e-5 (float32
products in another order), ``ffn_to_program`` giving array-equal streams,
``logic_ffn_apply`` with its hidden bits exact (the port's plain K1 path
against the reference's Pallas kernel in interpret mode) and its output
at 1e-5.  Then the reference's swap example at reduced size: a 2-layer
qwen3-smoke transformer whose FFNs are binarized, converted layer by
layer from calibration bits captured from the binary model, must equal
the binary model on those calibration batches (the ISF is exact on
observed patterns, and layer 1 sees only what layer 0 produced).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.spec import CompileSpec as RefSpec
from repro.kernels.logic_dsp.ops import logic_forward as ref_logic_forward
from repro.kernels.logic_dsp.ops import pack_bits_jnp, unpack_bits_jnp
from repro.models import attention as ref_attn
from repro.models import logic_mlp as ref_logic_mlp
from repro.models.layers import rms_norm as ref_rms_norm
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_from_reference
from repro_torch.core.spec import CompileSpec
from repro_torch.data import TokenPipeline
from repro_torch.models import logic_mlp
from repro_torch.models.transformer import Transformer

STREAMS = ("src_a", "src_b", "dst", "opcode", "step_branch", "output_addrs")
D, F = 48, 24                   # the reference swap's widths
SWAP = dict(n_layers=2, d_model=D, d_ff=F, n_heads=4, n_kv_heads=2,
            head_dim=12, vocab_size=256)
CALIB_BATCHES = 2               # TokenPipeline(256, 8, 32) batches


def _ffn_params(seed, d=D, f=F):
    rng = np.random.default_rng(seed)
    return {"w_in": (0.5 * rng.normal(size=(d, f))).astype(np.float32),
            "b_in": (0.1 * rng.normal(size=f)).astype(np.float32),
            "w_out": (0.1 * rng.normal(size=(f, d))).astype(np.float32)}


def _x(seed, shape=(2, 16, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _jnp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_ffn_matches_reference(seed):
    p, x = _ffn_params(seed), _x(seed + 10)
    got = logic_mlp.binary_ffn(_torch(p), torch.from_numpy(x))
    want = ref_logic_mlp.binary_ffn(_jnp(p), jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def converted():
    """One layer converted by both packages from the same calibration
    bits: (params, calibration bits, port program, reference program)."""
    p = _ffn_params(2)
    calib = np.random.default_rng(3).integers(0, 2, (256, D)).astype(
        np.uint8)
    prog = logic_mlp.ffn_to_program(_torch(p), calib, CompileSpec(n_unit=16))
    ref = ref_logic_mlp.ffn_to_program(_jnp(p), calib, RefSpec(n_unit=16))
    return p, calib, prog, ref


def test_ffn_to_program_same_streams_as_reference(converted):
    _, _, prog, ref = converted
    assert prog.n_gates > 0
    for f in STREAMS:
        np.testing.assert_array_equal(getattr(prog, f), getattr(ref, f))
    assert (prog.n_addr, prog.n_steps, prog.n_unit) == \
        (ref.n_addr, ref.n_steps, ref.n_unit)


@pytest.mark.parametrize("inputs", ["calibration", "held_out"])
def test_logic_ffn_apply_matches_reference(converted, inputs):
    p, calib, prog, ref = converted
    if inputs == "calibration":     # +-1 at the calibration bits
        x = (2.0 * calib[:160].reshape(2, 80, D) - 1.0).astype(np.float32)
    else:
        x = _x(4, (2, 80, D))
    h = logic_mlp.logic_hidden(prog, torch.from_numpy(x)).numpy()
    xb = jnp.asarray(x.reshape(-1, D) >= 0)
    ref_h = np.asarray(unpack_bits_jnp(ref_logic_forward(
        ref, pack_bits_jnp(xb)), xb.shape[0]))        # Pallas, interpret
    np.testing.assert_array_equal(h, ref_h)
    y = logic_mlp.logic_ffn_apply(prog, _torch(p), torch.from_numpy(x))
    want = ref_logic_mlp.logic_ffn_apply(ref, _jnp(p), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if inputs == "calibration":     # the ISF is exact on observed patterns
        np.testing.assert_array_equal(
            h, logic_mlp.binary_hidden(_torch(p), torch.from_numpy(x))
            .numpy())


def _ref_swap_forward(params, cfg, tokens):
    """The reference swap example's forward with its binarized FFN
    (``examples/logic_mlp_swap.py:24-36``)."""
    x = params["embed"].astype(jnp.float32)[tokens]
    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a, i=i: a[i], params["blocks"])
        h = ref_rms_norm(x, p["attn_norm"])
        x = x + ref_attn.attention_forward(p, h, cfg, positions=positions)
        h = ref_rms_norm(x, p["mlp_norm"])
        x = x + ref_logic_mlp.binary_ffn(p, h)
    x = ref_rms_norm(x, params["final_norm"])
    return x @ params["lm_head"].astype(x.dtype)


def test_logic_model_equals_binary_model_on_calibration_batches():
    ref_cfg = ref_get_config("qwen3-8b", smoke=True).with_(**SWAP)
    cfg = get_config("qwen3-8b", smoke=True).with_(**SWAP, logic_mlp=True)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    L = cfg.n_layers
    params["blocks"]["w_in"] = jnp.asarray(0.5 * rng.normal(size=(L, D, F)),
                                           jnp.float32)
    params["blocks"]["b_in"] = jnp.zeros((L, F), jnp.float32)
    params["blocks"]["w_out"] = jnp.asarray(0.1 * rng.normal(size=(L, F, D)),
                                            jnp.float32)
    for k in ("w_gate", "w_up", "w_down"):
        params["blocks"].pop(k)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(
        jax.tree.map(np.asarray, params), cfg))

    pipe = TokenPipeline(cfg.vocab_size, 8, 32, seed=0)
    batches = [torch.from_numpy(pipe.batch(900 + i)["tokens"])
               for i in range(CALIB_BATCHES)]
    np.testing.assert_allclose(
        model(batches[0]).numpy(),
        np.asarray(_ref_swap_forward(params, ref_cfg,
                                     jnp.asarray(batches[0].numpy()))),
        rtol=1e-4, atol=1e-4)

    captured = [[] for _ in range(L)]
    binary_logits = []
    for tokens in batches:
        inputs = []
        binary_logits.append(model(tokens, ffn_inputs=inputs))
        for i, h in enumerate(inputs):
            captured[i].append(h)
    for i, blk in enumerate(model.blocks):
        h = torch.cat(captured[i]).reshape(-1, D)
        blk.program = logic_mlp.ffn_to_program(
            blk.params(), (h >= 0).numpy(), CompileSpec(n_unit=16),
            name=f"ffn{i}")
        assert blk.program.n_gates > 0
    for tokens, want in zip(batches, binary_logits):
        inputs = []
        got = model(tokens, ffn_inputs=inputs)
        for i, (blk, h) in enumerate(zip(model.blocks, inputs)):
            np.testing.assert_array_equal(
                logic_mlp.logic_hidden(blk.program, h).numpy(),
                logic_mlp.binary_hidden(blk.params(), h).numpy())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# training: the straight-through estimator
# ---------------------------------------------------------------------------

STE_MARGIN = 1e-4     # every threshold's input at least this far from 0


def _margin_inputs(seed):
    """FFN params and inputs whose thresholds all keep STE_MARGIN: the
    block input itself (moved 1e-3 away from 0) and every hidden
    pre-activation (asserted)."""
    p, x = _ffn_params(seed), _x(seed + 20)
    x = np.where(x >= 0, x + 1e-3, x - 1e-3).astype(np.float32)
    pre = (2.0 * (x.reshape(-1, D) >= 0) - 1.0) @ p["w_in"] + p["b_in"]
    assert np.abs(x).min() >= STE_MARGIN, np.abs(x).min()
    assert np.abs(pre).min() >= STE_MARGIN, np.abs(pre).min()
    return p, x


@pytest.mark.parametrize("seed", [5, 6])
def test_ste_value_and_gradient_match_reference(seed):
    """binary_ffn's value and its gradient with respect to the input and
    all three weights against jax.grad of the reference's, for a random
    cotangent: value at 1e-5 (the reference's STE value is the hard one
    only up to float rounding), gradients at 1e-5 of each leaf's largest
    element."""
    p, x = _margin_inputs(seed)
    ct = np.random.default_rng(seed + 30).normal(size=x.shape).astype(
        np.float32)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = logic_mlp.binary_ffn(tp, tx)
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                              [tx, *tp.values()])

    def ref_fn(prm, xx):
        return jnp.sum(ref_logic_mlp.binary_ffn(prm, xx) * ct)

    ref_y = ref_logic_mlp.binary_ffn(_jnp(p), jnp.asarray(x))
    g_p, g_x = jax.grad(ref_fn, argnums=(0, 1))(_jnp(p), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=1e-5, atol=1e-5)
    want = [np.asarray(g_x)] + [np.asarray(g_p[k]) for k in tp]
    for name, g, w in zip(["x", *tp], got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    # the forward is the exact hard threshold: binary_hidden's bits
    xb = (x.reshape(-1, D) >= 0)
    h = ((2.0 * xb - 1.0) @ p["w_in"] + p["b_in"] >= 0)
    np.testing.assert_array_equal(
        logic_mlp.binary_hidden(_torch(p), torch.from_numpy(x)).numpy(), h)


def test_ste_forward_is_exact_and_backward_is_the_soft_derivative():
    y = torch.tensor([-2.0, -1e-7, 0.0, 1e-7, 0.3], requires_grad=True)
    out = logic_mlp.ste01(y)
    assert out.tolist() == [0.0, 0.0, 1.0, 1.0, 1.0]
    (g,) = torch.autograd.grad(out.sum(), y)
    t = torch.tanh(y.detach())
    assert torch.equal(g, 0.5 * (1.0 - t * t))


def _numpy_swap_params(ref_cfg, seed):
    """The swap model's reference tree with every weight drawn by numpy
    from ``seed`` (normal 0.02; the FFN's w_in 0.5 N(0,1), b_in 0, w_out
    0.1 N(0,1)); norms stay ones.  Unlike ``init_params``'s draws these
    are the same in every process."""
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    L = ref_cfg.n_layers

    def draw(a):
        a = np.asarray(a)
        if (a == 1).all():
            return jnp.asarray(a)
        return jnp.asarray(0.02 * rng.normal(size=a.shape), jnp.float32)

    params = jax.tree.map(draw, params)
    for k in ("w_gate", "w_up", "w_down"):
        params["blocks"].pop(k)
    params["blocks"]["w_in"] = jnp.asarray(0.5 * rng.normal(size=(L, D, F)),
                                           jnp.float32)
    params["blocks"]["b_in"] = jnp.zeros((L, F), jnp.float32)
    params["blocks"]["w_out"] = jnp.asarray(
        0.1 * rng.normal(size=(L, F, D)), jnp.float32)
    return params


def test_one_ste_training_step_matches_reference():
    """One step of the reference example's ``step_fn``
    (``examples/logic_mlp_swap.py:55-67``: the STE model's loss, its
    gradient, AdamW at lr 2e-3) against the port's ``train_ste`` for one
    step: the loss at 1e-5, the parameters within 0.1 lr, the moments at
    1e-3 (1e-6 / 1e-9 absolute).  Every threshold of the forward keeps a
    margin of 1e-5, asserted, so no bit rounds to the other side."""
    from repro_torch.examples import logic_mlp_swap as swap
    from repro.models.layers import softmax_xent as ref_xent
    from repro.optim import adamw_init as ref_adamw_init
    from repro.optim import adamw_update as ref_adamw_update
    from repro_torch.convert import adamw_state_from_reference

    ref_cfg = ref_get_config("qwen3-8b", smoke=True).with_(**SWAP)
    cfg = swap.swap_config()
    params = _numpy_swap_params(ref_cfg, 11)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    pipe = swap.pipeline(cfg)
    tokens = jnp.asarray(pipe.batch(0)["tokens"])

    ins = []
    with torch.no_grad():
        model(torch.from_numpy(np.array(tokens)), ffn_inputs=ins)
    for blk, h in zip(model.blocks, ins):
        pre = (2.0 * (h >= 0).float() - 1.0) @ blk.w_in + blk.b_in
        assert float(h.abs().min()) >= 1e-5 and \
            float(pre.abs().min()) >= 1e-5

    def loss_fn(prm, toks):
        logits = _ref_swap_forward(prm, ref_cfg, toks)
        return ref_xent(logits[:, :-1].astype(jnp.float32), toks[:, 1:])

    ref_loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, tokens)
    ref_params, ref_opt = ref_adamw_update(g, ref_adamw_init(params), params,
                                           lr=swap.LR)
    params_before = {k: v.clone() for k, v in model.state_dict().items()}
    (loss,) = swap.train_ste(model, pipe, steps=1, log=lambda *_: None)
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    want = transformer_params_from_reference(
        jax.tree.map(np.asarray, ref_params), cfg)
    for name, p in model.named_parameters():
        assert not torch.equal(p, params_before[name]) or name.endswith(
            "norm"), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=0.1 * swap.LR, err_msg=name)
    want_opt = adamw_state_from_reference(jax.tree.map(np.asarray, ref_opt),
                                          cfg)
    assert want_opt.step == 1


@pytest.fixture(scope="module")
def trained_swap():
    """The port's example flow on the CPU: 150 STE steps, then capture and
    conversion from 2 calibration batches (``n_unit`` 16)."""
    from repro_torch.examples import logic_mlp_swap as swap
    cfg = swap.swap_config()
    model = swap.init_swap_model(cfg, 0, "cpu")
    pipe = swap.pipeline(cfg)
    losses = swap.train_ste(model, pipe, log=lambda *_: None)
    calib = [swap.tokens_of(pipe, swap.CALIB_FIRST + i, "cpu")
             for i in range(CALIB_BATCHES)]
    layers = swap.convert(model, swap.capture_bits(model, calib),
                          log=lambda *_: None)
    return swap, model, calib, losses, layers


def test_trained_logic_ffn_is_exact_on_its_calibration_batches(trained_swap):
    swap, model, calib, losses, layers = trained_swap
    assert len(losses) == swap.STEPS and all(np.isfinite(losses))
    assert [ly["samples"] for ly in layers] == [CALIB_BATCHES * 8 * 32] * 2
    programs = [blk.program for blk in model.blocks]
    assert all(p.n_gates > 0 for p in programs)
    for tokens in calib:
        ins = []
        logic = swap.forward_with(model, tokens, programs, ffn_inputs=ins)
        for blk, h in zip(model.blocks, ins):
            np.testing.assert_array_equal(
                logic_mlp.logic_hidden(blk.program, h).numpy(),
                logic_mlp.binary_hidden(blk.params(), h).numpy())
        ste = swap.forward_with(model, tokens, [None] * len(programs))
        assert torch.equal(logic, ste)
    held = swap.compare(model, programs, swap.tokens_of(
        swap.pipeline(model.cfg), swap.HELD_OUT, "cpu"))
    assert 0.0 <= held["argmax_agreement"] <= 1.0
    assert np.isfinite(held["loss_logic"]) and np.isfinite(held["loss_ste"])
