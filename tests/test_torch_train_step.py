"""The port's train step held against the reference's jitted step
(``jax.jit(make_train_step(cfg, tc))``, no mesh) on the CPU.

Both sides start from the same state: the reference's parameters and
optimizer state after one reference step (non-zero moments), carried
across in this process with ``convert.transformer_params_from_reference``
and ``convert.adamw_state_from_reference`` (the reference seeds its leaves
with ``hash(path)``, salted per process).  Then two steps on the same
``TokenPipeline`` batches, for qwen3-8b and minicpm-2b smoke (GQA +
qk-norm; MHA + tied embeddings + WSD), with ``grad_accum`` 1 and 2 and the
int8 gradient round trip off and on; after each step ``loss``,
``grad_norm``, ``lr``, every parameter and both moments are compared in
float32.

Tolerances, and why:
  * ``loss``, ``grad_norm``: rtol 1e-5 (float32 sums in another order);
    ``lr``: rtol 1e-6 (the schedule in float32 on both sides).
  * parameters: atol 1e-4 = 0.1 lr.  Adam moves an element by about lr
    whatever its gradient's size, so an element whose gradient is a
    cancellation near zero turns float32 noise into a visible share of lr.
  * moments: rtol 1e-3, atol 1e-6 (``mu``) and 1e-9 (``nu``).
  * With the int8 round trip, a gradient element whose float32 noise
    straddles a rounding midpoint lands on the neighbouring int8 level
    and moves its moments by a whole level (and XLA's jitted
    ``amax / 127``, a multiplication by the reciprocal, is one ulp from
    the division in about half the blocks).  So at most 1e-3 of the
    elements may fall outside the tolerances above; measured 2e-5 to
    1.4e-4 over two steps.  A fault of the block layout (blocks cut per
    layer where the reference's run over the layer-stacked leaf) puts 6%
    of minicpm's moments outside.  On the same input the quantization is
    bit-exact (``test_torch_optim.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import init_params as ref_init_params
from repro.optim import adamw_init as ref_adamw_init
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_reference,
                                 transformer_params_from_reference)
from repro_torch.data import TokenPipeline
from repro_torch.models.transformer import Transformer
from repro_torch.train import TrainConfig, make_train_step

P_TOL = dict(rtol=0.0, atol=1e-4)
MU_TOL = dict(rtol=1e-3, atol=1e-6)
NU_TOL = dict(rtol=1e-3, atol=1e-9)
INT8_OUTLIERS = 1e-3


def _outside(got: torch.Tensor, want: torch.Tensor, tol: dict) -> int:
    return int((~torch.isclose(got.float(), want.float(), **tol)).sum())


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-8b", "minicpm-2b"])
def test_train_step_matches_reference(arch, grad_accum, compress):
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5,
              schedule="wsd" if arch == "minicpm-2b" else "cosine",
              grad_accum=grad_accum, compress_grads=compress)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(**kw)))
    step = make_train_step(cfg, TrainConfig(**kw))
    pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=0)

    def batch(i):
        return pipe.batch(i)["tokens"]

    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    ref_opt = ref_adamw_init(params)
    params, ref_opt, _ = ref_step(params, ref_opt,
                                  {"tokens": jnp.asarray(batch(99))})
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    opt = adamw_state_from_reference(jax.tree.map(np.asarray, ref_opt), cfg)
    assert opt.step == 1 and any(bool(m.any()) for m in opt.mu.values())

    n_elems = sum(p.numel() for p in model.parameters())
    allowed = int(INT8_OUTLIERS * n_elems) if compress else 0
    for i in range(2):
        params, ref_opt, ref_m = ref_step(params, ref_opt,
                                          {"tokens": jnp.asarray(batch(i))})
        model, opt, m = step(model, opt, {"tokens": torch.from_numpy(
            batch(i))})
        assert opt.step == int(ref_opt.step) == i + 2
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            assert float(m[k]) == pytest.approx(float(ref_m[k]), rel=rtol)
        want_p = transformer_params_from_reference(
            jax.tree.map(np.asarray, params), cfg)
        want_o = adamw_state_from_reference(
            jax.tree.map(np.asarray, ref_opt), cfg)
        outside = {
            "params": sum(_outside(p.detach(), want_p[n], P_TOL)
                          for n, p in model.named_parameters()),
            "mu": sum(_outside(opt.mu[n], want_o.mu[n], MU_TOL)
                      for n in opt.mu),
            "nu": sum(_outside(opt.nu[n], want_o.nu[n], NU_TOL)
                      for n in opt.nu)}
        assert all(v <= allowed for v in outside.values()), \
            (i, outside, allowed)
