"""The port's optimizer, schedules, clipping and int8 compression, held
against the JAX package's ``repro.optim`` on the same numpy-seeded inputs,
and the port's counterparts of the reference's optimizer tests
(``tests/test_train.py:22-85``).

Tolerances: float32 results within a few ulps (rtol 1e-6; the two
frameworks round ``pow``, ``cos``, ``sqrt`` and a division by a scalar
each their own way); a value stored in bfloat16 within one bfloat16 ulp
(rtol 2**-7), since a float32 difference of one ulp can round it to the
neighbouring bfloat16.  Int8 quantization is exact: ``q`` and ``scale``
bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip as ref_clip
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_sched
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_int8, cosine_schedule,
                               decompress_int8, ef_compress, linear_warmup,
                               resolve_moment_dtype, wsd_schedule)
from repro_torch.optim import compression
from repro_torch.optim.clip import global_norm

F32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-7)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = {"w": (17, 33), "b": (33,), "norm": (5,)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(tree, dtype):
    """The tree for each package, in separate memory: the port updates in
    place, and jnp.asarray may alias a numpy buffer on the CPU."""
    tdt, jdt = DT[dtype]
    return ({k: torch.tensor(v, dtype=tdt) for k, v in tree.items()},
            {k: jnp.asarray(v, jdt) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr", ["scalar", "schedule"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype, moments, lr):
    """adamw_init, then 3 updates from non-zero moments: params and moments
    after each, and the step."""
    params, ref_params = _both(_tree(0), param_dtype)
    state = adamw_init(params, resolve_moment_dtype(moments))
    ref_state = ref_adamw_init(ref_params, DT[moments][1])
    kw = dict(weight_decay=0.1)
    for i in range(3):
        grads, ref_grads = _both(_tree(10 + i, scale=0.01), param_dtype)
        if lr == "scalar":
            rate, ref_rate = 3e-3, 3e-3
        else:
            rate = wsd_schedule(3e-3, 2, 3, 4)
            ref_rate = ref_sched.wsd_schedule(3e-3, 2, 3, 4)
        params, state = adamw_update(grads, state, params, lr=rate, **kw)
        ref_params, ref_state = ref_adamw_update(
            ref_grads, ref_state, ref_params, lr=ref_rate, **kw)
        assert state.step == int(ref_state.step) == i + 1
        p_tol = F32_TOL if param_dtype == "float32" else BF16_TOL
        m_tol = F32_TOL if moments == "float32" else BF16_TOL
        for k in SHAPES:
            assert params[k].dtype == DT[param_dtype][0]
            assert state.mu[k].dtype == DT[moments][0]
            np.testing.assert_allclose(_np(params[k]), _np(ref_params[k]),
                                       **p_tol)
            np.testing.assert_allclose(_np(state.mu[k]),
                                       _np(ref_state.mu[k]), **m_tol)
            np.testing.assert_allclose(_np(state.nu[k]),
                                       _np(ref_state.nu[k]), **m_tol)


def test_adamw_updates_in_place():
    params = {"w": torch.ones(4)}
    state = adamw_init(params)
    w, mu = params["w"], state.mu["w"]
    out, state = adamw_update({"w": torch.full((4,), 0.5)}, state, params,
                              lr=0.1)
    assert out is params and out["w"] is w and state.mu["w"] is mu
    assert (w < 1).all() and (mu > 0).all()


def test_resolve_moment_dtype_refuses_unknown():
    assert resolve_moment_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_moment_dtype("float16")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads, ref_grads = _both(_tree(3, scale=0.3), "float32")
    grads["norm"] = grads["norm"].to(torch.bfloat16)
    ref_grads["norm"] = ref_grads["norm"].astype(jnp.bfloat16)
    np.testing.assert_allclose(_np(global_norm(grads)),
                               _np(ref_clip.global_norm(ref_grads)),
                               **F32_TOL)
    clipped, norm = clip_by_global_norm(grads, max_norm)
    ref_clipped, ref_norm = ref_clip.clip_by_global_norm(ref_grads, max_norm)
    np.testing.assert_allclose(_np(norm), _np(ref_norm), **F32_TOL)
    assert clipped["norm"].dtype == torch.bfloat16
    for k in SHAPES:
        tol = BF16_TOL if k == "norm" else F32_TOL
        np.testing.assert_allclose(_np(clipped[k]), _np(ref_clipped[k]),
                                   **tol)


def _schedules():
    return {"wsd": (wsd_schedule(1e-3, 10, 80, 20),
                    ref_sched.wsd_schedule(1e-3, 10, 80, 20)),
            "wsd_final_frac": (wsd_schedule(2.0, 3, 5, 7, final_frac=0.3),
                               ref_sched.wsd_schedule(2.0, 3, 5, 7, 0.3)),
            "cosine": (cosine_schedule(1e-3, 10, 100),
                       ref_sched.cosine_schedule(1e-3, 10, 100)),
            "linear_warmup": (lambda s: linear_warmup(s, 10, 1e-3),
                              lambda s: ref_sched.linear_warmup(s, 10, 1e-3)),
            "no_warmup": (cosine_schedule(1.0, 0, 50),
                          ref_sched.cosine_schedule(1.0, 0, 50))}


@pytest.mark.parametrize("name", sorted(_schedules()))
def test_schedules_match_reference(name):
    fn, ref_fn = _schedules()[name]
    steps = list(range(0, 125)) + [1000]
    got = np.array([_np(fn(s)) for s in steps])
    want = np.array([_np(ref_fn(s)) for s in steps])
    assert all(fn(s).dtype == torch.float32 for s in (0, 50))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("shape", [(1,), (255,), (257,), (1000,), (4097,),
                                   (3, 5, 7), (256,)])
def test_int8_compression_matches_reference_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.normal(size=shape) * rng.uniform(1e-4, 1.0)).astype(np.float32)
    q, scale = compress_int8(torch.from_numpy(g))
    ref_q, ref_scale = ref_comp.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    for dt in ("float32", "bfloat16"):
        rec = decompress_int8(q, scale, shape, DT[dt][0])
        want = ref_comp.decompress_int8(ref_q, ref_scale, shape, DT[dt][1])
        assert rec.shape == shape and rec.dtype == DT[dt][0]
        np.testing.assert_array_equal(_np(rec), _np(want))


@pytest.mark.parametrize("shape", [(300,), (2, 257)])
def test_error_feedback_matches_reference(shape):
    rng = np.random.default_rng(7)
    g = rng.normal(size=shape).astype(np.float32)
    res = (0.01 * rng.normal(size=shape)).astype(np.float32)
    q, scale, new_res = ef_compress(torch.from_numpy(g),
                                    torch.from_numpy(res))
    rq, rs, rres = ref_comp.ef_compress(jnp.asarray(g), jnp.asarray(res))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(rres))
    # the sum over 3 participants of their int8 q, at the summed scales
    q_sum, s_sum = 3 * q.to(torch.int32), 3 * scale
    got = compression.ef_decompress_apply(q_sum, s_sum, shape, 3)
    want = ref_comp.ef_decompress_apply(jnp.asarray(q_sum.numpy()),
                                        jnp.asarray(s_sum.numpy()), shape, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state = compression.ef_init({"g": torch.from_numpy(g)})
    assert state.residual["g"].dtype == torch.float32
    assert not state.residual["g"].any()


# ---------------------------------------------------------------------------
# the reference's own optimizer tests, on the port
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(grads, state, params, lr=0.05,
                                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.3


def test_wsd_schedule_shape():
    fn = wsd_schedule(1.0, warmup_steps=10, stable_steps=80, decay_steps=10)
    assert float(fn(0)) == 0.0
    assert float(fn(10)) == pytest.approx(1.0)
    assert float(fn(50)) == pytest.approx(1.0)      # stable plateau
    assert float(fn(100)) == pytest.approx(0.1, rel=0.05)


def test_cosine_schedule_monotone_decay():
    fn = cosine_schedule(1.0, 5, 100)
    vals = [float(fn(s)) for s in range(5, 100, 5)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)


def test_int8_roundtrip_error_bound(rng):
    g = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    q, s = compress_int8(g)
    rec = decompress_int8(q, s, g.shape)
    # blockwise symmetric quantization: |err| <= scale/2 per block
    err = (rec - g).abs().numpy()
    scales = np.repeat(s.numpy().reshape(-1), 256)[:1000]
    assert (err <= scales / 2 + 1e-7).all()


def test_error_feedback_accumulates():
    g = torch.full((256,), 1e-4)          # below quantization step alone
    residual = torch.zeros(256)
    total = torch.zeros(256)
    for _ in range(50):
        q, s, residual = ef_compress(g, residual)
        total = total + decompress_int8(q, s, g.shape)
    # EF: the long-run average transmitted equals the true gradient
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), rtol=0.2)
