"""The port's XNOR-popcount GEMM (K3) against the JAX reference.

``pack_pm1``, ``xnor_gemm(..., device="cpu")`` (the packed plain version)
and ``xnor_packed_ref`` must equal the reference's ``pack_pm1``,
``xnor_gemm`` (Pallas in interpret mode, as ``tests/test_kernels.py`` runs
it) and ``xnor_gemm_ref`` bit for bit: the arithmetic is integer, so there
is no tolerance.  The CUDA kernel is held against its plain version on the
card (marked ``cuda``; it skips here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xnor_gemm import pack_pm1 as ref_pack_pm1
from repro.kernels.xnor_gemm import xnor_gemm as ref_xnor_gemm
from repro.kernels.xnor_gemm import xnor_gemm_ref as ref_xnor_gemm_ref
from repro_torch.kernels.xnor_gemm import (pack_pm1, xnor_and_popc_ref,
                                           xnor_gemm, xnor_gemm_ref,
                                           xnor_packed_ref)
from repro_torch.kernels.xnor_gemm import kernel as _k

# the reference test's shapes and TPU tiles (tests/test_kernels.py)
REF_SHAPES = [
    (64, 48, 100, dict(bm=32, bn=32, bk=2)),
    (128, 128, 512, dict(bm=128, bn=128, bk=16)),
    (17, 5, 33, dict(bm=8, bn=8, bk=1)),
    (256, 64, 2304, dict(bm=64, bn=64, bk=8)),  # VGG16 conv fanin
]
# ragged edges: every M and N in {1, 17, 4097} and every k in
# {1, 33, 100, 2304} (Kw 1, 2, 4, 72), at the reference's default tiles
RAGGED = [(1, 1, 2304), (1, 17, 1), (17, 1, 33), (17, 17, 100),
          (4097, 17, 100), (17, 4097, 2304), (1, 4097, 33),
          (4097, 1, 2304), (4097, 4097, 1)]
CASES = [(m, n, k, tiles) for m, n, k, tiles in REF_SHAPES] + \
        [(m, n, k, {}) for m, n, k in RAGGED]


def _bits(seed, rows, k):
    """{0,1} uint8 from a seed; row 0 has every bit set, so each of its
    words with 32 real bits has bit 31 set (a negative int32)."""
    x = np.random.default_rng(seed).integers(0, 2, (rows, k)).astype(np.uint8)
    x[0] = 1
    return x


@pytest.mark.parametrize("rows,k", [(5, 70), (3, 32), (4, 31), (2, 1),
                                    (7, 2304), (1, 0)])
def test_pack_pm1_equals_reference(rows, k):
    bits = _bits(rows * 1000 + k, rows, k)
    got = pack_pm1(torch.from_numpy(bits))
    want = np.asarray(ref_pack_pm1(jnp.asarray(bits)))
    assert got.dtype == torch.int32 and got.shape == (rows, -(-k // 32))
    np.testing.assert_array_equal(got.numpy(), want)
    if k >= 32:
        assert (want < 0).any(), "bit 31 set somewhere"


@pytest.mark.parametrize("m,n,k,tiles", CASES,
                         ids=[f"{m}x{n}x{k}" for m, n, k, _ in CASES])
def test_xnor_gemm_equals_reference(m, n, k, tiles):
    a = _bits(m + 7 * n + k, m, k)
    b = _bits(3 * m + n + k, n, k)
    want = np.asarray(ref_xnor_gemm(jnp.asarray(a), jnp.asarray(b), **tiles))
    np.testing.assert_array_equal(
        want, np.asarray(ref_xnor_gemm_ref(jnp.asarray(a), jnp.asarray(b))))
    got = xnor_gemm(a, b, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        xnor_packed_ref(pack_pm1(ta), pack_pm1(tb), k).numpy(), want)
    np.testing.assert_array_equal(xnor_gemm_ref(ta, tb).numpy(), want)


# Kw not a multiple of the kernel's 8-word k-step, LeNet-5 fc1's k 400
# (Kw 13) and VGG16's 2304 (Kw 72) among them
AND_POPC = [c[:3] for c in CASES] + [(9, 7, 400), (33, 65, 416), (5, 3, 31),
                                     (70, 9, 2300), (3, 130, 288)]


@pytest.mark.parametrize("m,n,k", AND_POPC,
                         ids=[f"{m}x{n}x{k}" for m, n, k in AND_POPC])
def test_and_popc_identity_equals_reference(m, n, k):
    """The kernel's own arithmetic, popc(a ^ b) = popc(a) + popc(b) -
    2 popc(a & b) on the packed words with zero words past k, equals the
    plain twin, the port's oracle and the reference's Pallas kernel
    (interpret mode) bit for bit; row 0 of A is all ones."""
    a = _bits(5 * m + n + k, m, k)
    b = _bits(m + 5 * n + k, n, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ap, bp = pack_pm1(ta), pack_pm1(tb)
    got = xnor_and_popc_ref(ap, bp, k)
    pad = (-ap.shape[1]) % 8                   # to the kernel's k-step
    padded = xnor_and_popc_ref(torch.nn.functional.pad(ap, (0, pad)),
                               torch.nn.functional.pad(bp, (0, pad)), k)
    want = np.asarray(ref_xnor_gemm(jnp.asarray(a), jnp.asarray(b)))
    for x in (got, padded, xnor_packed_ref(ap, bp, k), xnor_gemm_ref(ta, tb)):
        np.testing.assert_array_equal(x.numpy(), want)


def test_k_mismatch_raises():
    a, b = _bits(0, 4, 40), _bits(1, 3, 41)
    with pytest.raises(ValueError, match="K mismatch: 40 vs 41"):
        xnor_gemm(a, b, device="cpu")
    with pytest.raises(ValueError, match="K mismatch"):
        ref_xnor_gemm(jnp.asarray(a), jnp.asarray(b))


def test_cpu_path_launches_nothing():
    before = _k.launch_count("xnor")
    xnor_gemm(_bits(2, 9, 70), _bits(3, 5, 70), device="cpu")
    assert _k.launch_count("xnor") == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card-only tests without JAX "
                    "are in tests/test_torch_device.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [c[:3] for c in CASES],
                         ids=[f"{m}x{n}x{k}" for m, n, k, _ in CASES])
def test_kernel_matches_plain_on_card(cuda, m, n, k):
    a = _bits(m + 7 * n + k, m, k)
    b = _bits(3 * m + n + k, n, k)
    before = _k.launch_count("xnor")
    got = xnor_gemm(a, b, device=cuda)
    torch.cuda.synchronize()
    assert _k.launch_count("xnor") == before + 1
    ap = pack_pm1(torch.from_numpy(a).to(cuda))
    bp = pack_pm1(torch.from_numpy(b).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  xnor_packed_ref(ap, bp, k).cpu().numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        xnor_gemm_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy())
