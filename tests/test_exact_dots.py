"""Exactness of the integer and float dots behind prime-field matmuls and
the 4-step NTT: int8 balanced planes against Python-int references, and
the stated precision of the f32 products."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import galois_tpu as gt
from galois_tpu.ops import _linalg
from galois_tpu.ops._linalg import (
    _PLANE_MAXD,
    _prime_matmul_planes,
    balanced_plane_count,
    balanced_planes_np,
)

P_NEAR_2_32 = 2**32 - 5  # largest prime below 2^32: needs a 5th plane


def _kdiag(p):
    return (2**31 - 1) // (_PLANE_MAXD**2 * balanced_plane_count(p))


def _deferred_limit(p):
    """Largest K that takes the deferred-mod branch."""
    n = balanced_plane_count(p)
    return (2**62 - 1) // (n * n * _PLANE_MAXD**2 * (p - 1))


def _ref_matmul(a, b, p):
    return np.asarray(
        np.dot(a.astype(object), b.astype(object)) % p, dtype=np.int64
    )


def _operands(p, K, seed, M=2, N=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, p, (M, K), dtype=np.int64)
    b = rng.integers(0, p, (K, N), dtype=np.int64)
    # extreme residues exercise the balanced-digit edges
    a[0, :2] = [p - 1, p // 2 + 1]
    b[:2, 0] = [p - 1, p // 2]
    return a, b


_CASES = [
    (p, K)
    for p in (257, 2**31 - 1, 3 * 2**30 + 1, P_NEAR_2_32)
    for K in (255, 511)
] + [
    (257, _kdiag(257) + 1),  # deferred branch, two kdiag blocks
    (2**31 - 1, _deferred_limit(2**31 - 1) + 1),  # per-pair mod branch
    (3 * 2**30 + 1, _deferred_limit(3 * 2**30 + 1) + 1),
    (P_NEAR_2_32, _deferred_limit(P_NEAR_2_32) + 1),
]


@pytest.mark.parametrize("p,K", _CASES)
def test_prime_matmul_against_python_ints(p, K):
    a, b = _operands(p, K, seed=K)
    dt = jnp.uint32
    got = _prime_matmul_planes(jnp.asarray(a, dt), jnp.asarray(b, dt), p, K)
    assert np.array_equal(np.asarray(got).astype(np.int64), _ref_matmul(a, b, p))


@pytest.mark.parametrize("p", [257, 2**31 - 1, 3 * 2**30 + 1, P_NEAR_2_32])
def test_precomputed_planes_match_runtime_extraction(p):
    K = 300
    a, b = _operands(p, K, seed=p % 1000, M=4, N=5)
    dt = jnp.uint32
    want = _ref_matmul(a, b, p)
    left = _prime_matmul_planes(None, jnp.asarray(b, dt), p, K, a_planes=jnp.asarray(balanced_planes_np(a, p)))
    right = _prime_matmul_planes(jnp.asarray(a, dt), None, p, K, b_planes=jnp.asarray(balanced_planes_np(b, p)))
    assert np.array_equal(np.asarray(left).astype(np.int64), want)
    assert np.array_equal(np.asarray(right).astype(np.int64), want)


def test_kernel_branch_boundaries():
    """The cases above really straddle the branches they are named for."""
    assert _kdiag(257) < _deferred_limit(257)
    for p in (2**31 - 1, 3 * 2**30 + 1, P_NEAR_2_32):
        assert _deferred_limit(p) < _kdiag(p)
    assert balanced_plane_count(P_NEAR_2_32) == 5
    assert balanced_plane_count(2**31 - 1) == 4


def _f32_dots_all_highest(fn, *args) -> bool:
    """Every f32 dot_general in fn's jaxpr asks for HIGHEST precision."""
    text = str(jax.make_jaxpr(fn)(*args))
    dots = re.findall(r"dot_general\[(.*?)preferred_element_type=(\w+)", text, re.S)
    f32 = [params for params, out_type in dots if out_type == "float32"]
    return bool(f32) and all("precision=(Precision.HIGHEST, Precision.HIGHEST)" in d for d in f32)


def test_gf2_matmul_f32_dot_is_highest():
    a = jnp.ones((4, 8), jnp.uint8)
    assert _f32_dots_all_highest(lambda x, y: _linalg._gf2_matmul(x, y, 8), a, a.T)


def test_digit_matmul_f32_dot_is_highest():
    from galois_tpu.ops._digit_matmul import digit_matmul

    F = gt.GF(3**5)
    a = jnp.ones((4, 8), F._meta.internal_dtype)
    assert _f32_dots_all_highest(lambda x, y: digit_matmul(F._meta, x, y), a, a.T)


def test_digit_matmul_large_digits_exact():
    """Digits above 2^11 (TF32's exact range) in GF(4093^2)."""
    F = gt.GF(4093**2)
    rng = np.random.default_rng(0)
    A = F(rng.integers(0, F.order, (3, 7)))
    B = F(rng.integers(0, F.order, (7, 2)))
    got = np.asarray(A @ B)
    hf_mul = lambda x, y: int(F(x) * F(y))  # noqa: E731
    hf_add = lambda x, y: int(F(x) + F(y))  # noqa: E731
    a, b = np.asarray(A), np.asarray(B)
    for i in range(3):
        for j in range(2):
            acc = 0
            for k in range(7):
                acc = hf_add(acc, hf_mul(int(a[i, k]), int(b[k, j])))
            assert got[i, j] == acc


def test_matmul_fft_plan_512x512_against_direct_dft():
    import chip_smoke
    from galois_tpu.ops._ntt import MatmulFFTPlan, _fft_jit, _get_omega, _plan

    p = 3 * 2**30 + 1
    F = gt.GF(p)
    N = 512 * 512
    plan = _plan(F._meta, N, _get_omega(F, N), "jit-calculate")
    assert isinstance(plan, MatmulFFTPlan) and plan.n1 == plan.n2 == 512
    x = np.random.default_rng(1).integers(0, p, N)
    X = np.asarray(_fft_jit(plan)(jnp.asarray(x, F._meta.internal_dtype)))
    ks = np.array([0, 1, 511, 512, 4097, N // 2, N - 2, N - 1])
    assert chip_smoke._direct_dft_ok(x.astype(np.uint64), X[ks], p, ks)


def test_inverse_scaling_compiles_once():
    from galois_tpu.ops._ntt import scale_jit

    F = gt.GF(257)
    x = F.Random(16, seed=0)
    np.fft.ifft(np.fft.fft(x))
    before = scale_jit.cache_info().hits
    assert np.array_equal(np.asarray(np.fft.ifft(np.fft.fft(x))), np.asarray(x))
    assert scale_jit.cache_info().hits == before + 1


@pytest.mark.parametrize("K", [1, 3, 4, 5, 7, 8, 9])
def test_int8_matmul_small_contractions(K):
    rng = np.random.default_rng(K)
    a = rng.integers(-128, 128, (2, 6, K)).astype(np.int8)
    b = rng.integers(-128, 128, (2, K, 5)).astype(np.int8)
    got = _linalg.int8_matmul(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == jnp.int32
    assert np.array_equal(np.asarray(got), np.einsum("bmk,bkn->bmn", a.astype(np.int64), b.astype(np.int64)))


@pytest.mark.parametrize("K", [1, 2, 3, 5, 17, 255])
def test_int8_matmul_pads_contraction_to_multiple_of_4(K):
    """The dot XLA sees has K rounded up to a multiple of 4."""
    a = jnp.zeros((3, K), jnp.int8)
    b = jnp.zeros((K, 2), jnp.int8)
    eqns = [e for e in jax.make_jaxpr(_linalg.int8_matmul)(a, b).jaxpr.eqns if e.primitive.name == "dot_general"]
    assert [e.invars[0].aval.shape[-1] for e in eqns] == [-(-K // 4) * 4]


@pytest.mark.gpu
def test_int8_matmul_exact_on_gpu(gpu_device):
    """Every contraction size from 1 to 64 and larger ones, compiled for
    the card, at the shapes where XLA's raw dot went wrong."""
    import chip_smoke

    with jax.default_device(gpu_device):
        chip_smoke.phase_dots(shapes=((1, 1152, 4599), (1, 8192, 2040)))
