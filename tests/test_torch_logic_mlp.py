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
