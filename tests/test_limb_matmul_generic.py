"""Generic limb-prime int8-plane matmul (BLS12-381 scalar field) and its NTT plan.

The Goldilocks path has its own suite (test_kernels_regression.py); these pin
the generic digit-plane path (ops/_limb_matmul.py::generic_limb_matmul) that
serves every other planar-limb prime — exactness vs host big-int math, the
batched-side folds, and the MatmulFFTPlan route (SURVEY M6 / config 5).
"""

import numpy as np
import pytest

BLS_R = 52435875175126190479447740508185965837690552500527637822603658699938581184513


@pytest.fixture(scope="module")
def F():
    import galois_tpu as gt

    return gt.GF(BLS_R)


def _host(F):
    from galois_tpu.fields._hostfield import get_host_field

    return get_host_field(F._meta)


def _rand(rng, shape):
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        out[idx] = int.from_bytes(rng.bytes(40), "little") % BLS_R
    return out


def _host_matmul(hf, A, B):
    M, K = A.shape
    K2, N = B.shape
    out = np.zeros((M, N), dtype=object)
    for i in range(M):
        for j in range(N):
            acc = 0
            for k in range(K):
                acc = hf.add(acc, hf.multiply(int(A[i, k]), int(B[k, j])))
            out[i, j] = acc
    return out


def test_generic_limb_matmul_exact(F):
    from galois_tpu.ops._limb_matmul import generic_limb_matmul

    hf = _host(F)
    rng = np.random.default_rng(0)
    A, B = _rand(rng, (5, 7)), _rand(rng, (7, 6))
    out = generic_limb_matmul(F._meta, F(A)._data, F(B)._data)
    got = np.asarray(F._view(out, None), dtype=object)
    assert np.array_equal(got, _host_matmul(hf, A, B))


def test_generic_limb_matmul_max_values(F):
    from galois_tpu.ops._limb_matmul import generic_limb_matmul

    A = np.full((3, 4), BLS_R - 1, dtype=object)
    B = np.full((4, 2), BLS_R - 1, dtype=object)
    out = generic_limb_matmul(F._meta, F(A)._data, F(B)._data)
    got = np.asarray(F._view(out, None), dtype=object)
    assert np.all(got == (4 * pow(BLS_R - 1, 2, BLS_R)) % BLS_R)


def test_generic_limb_matmul_batched(F):
    from galois_tpu.ops._limb_matmul import generic_limb_matmul

    hf = _host(F)
    rng = np.random.default_rng(1)
    A = _rand(rng, (3, 4))
    Bb = _rand(rng, (2, 4, 3))
    out = generic_limb_matmul(F._meta, F(A)._data, F(Bb)._data)
    got = np.asarray(F._view(out, None), dtype=object)
    for t in range(2):
        assert np.array_equal(got[t], _host_matmul(hf, A, Bb[t]))


def test_public_matmul_operator(F):
    hf = _host(F)
    rng = np.random.default_rng(2)
    A, B = _rand(rng, (4, 5)), _rand(rng, (5, 3))
    got = np.asarray(F(A) @ F(B), dtype=object)
    assert np.array_equal(got, _host_matmul(hf, A, B))


def test_bls_ntt_matmul_plan_exact(F):
    from galois_tpu.ops._ntt import MatmulFFTPlan, _fft_jit, _get_omega, _plan

    hf = _host(F)
    N = 128
    om = _get_omega(F, N)
    plan = _plan(F._meta, N, om, "jit-calculate")
    assert isinstance(plan, MatmulFFTPlan)
    rng = np.random.default_rng(3)
    xs = _rand(rng, (N,))
    got = np.asarray(F._view(_fft_jit(plan)(F(xs)._data), None), dtype=object)
    pw = [1] * N
    for k in range(1, N):
        pw[k] = hf.multiply(pw[k - 1], om)
    for k in (0, 1, 77, N - 1):
        acc = 0
        for n in range(N):
            acc = hf.add(acc, hf.multiply(int(xs[n]), pw[(n * k) % N]))
        assert int(got[k]) == acc


def test_bls_ntt_roundtrip(F):
    from galois_tpu.ops._kernels import get_ops
    from galois_tpu.ops._ntt import _fft_jit, _get_omega, _plan

    hf = _host(F)
    N = 1024
    om = _get_omega(F, N)
    x = F.Random(N, seed=4)
    X = _fft_jit(_plan(F._meta, N, om, "jit-calculate"))(x._data)
    xi = _fft_jit(_plan(F._meta, N, hf.reciprocal(om), "jit-calculate"))(X)
    ops = get_ops(F._meta, "jit-calculate")
    back = ops.multiply(xi, ops.from_int_scalar(hf.reciprocal(N % BLS_R)))
    assert np.array_equal(np.asarray(back), np.asarray(x._data))


def test_multiply_unrolled_parity():
    """The unrolled elementwise limb multiply (large one-shot twiddles,
    LimbPrimeOps unroll=True) is bit-exact vs the default fold path."""
    import jax.numpy as jnp

    import galois_tpu as g
    from galois_tpu.ops._kernels import get_ops

    r = 52435875175126190479447740508185965837690552500527637822603658699938581184513
    F = g.GF(r)
    ops = get_ops(F._meta, "jit-calculate")
    rng = np.random.default_rng(0)
    vals = [
        (int(a) | (int(b) << 64) | (int(c) << 128) | (int(d) << 192)) % r
        for a, b, c, d in rng.integers(0, 2**63, (300, 4), dtype=np.uint64)
    ]
    vals += [0, 1, r - 1, 2**255 % r]
    A = F(vals)
    B = F(vals[::-1])
    m_fold = ops.multiply(A._data, B._data)
    m_unroll = ops.join_limbs(
        ops.multiply_t(ops.split_limbs(A._data), ops.split_limbs(B._data), unroll=True)
    )
    assert np.array_equal(np.asarray(m_fold), np.asarray(m_unroll))


def test_glm_unrolled_combine_parity(monkeypatch):
    """generic_limb_matmul's combine stage gives identical results with the
    unrolled and fold formulations (`unroll_one_shot` picks between them
    by array size)."""
    import jax.numpy as jnp

    import galois_tpu as g
    from galois_tpu.ops import _kernels
    from galois_tpu.ops import _limb_matmul as glm

    r = 52435875175126190479447740508185965837690552500527637822603658699938581184513
    F = g.GF(r)
    rng = np.random.default_rng(1)
    n = 24
    vals = rng.integers(0, 2**16, (2, F._meta.storage_width, n, n), dtype=np.int64)
    a = jnp.asarray(np.asarray(vals[0], dtype=np.uint16))
    b = jnp.asarray(np.asarray(vals[1], dtype=np.uint16))

    assert not _kernels.unroll_one_shot(F._meta.storage_width, n * n)
    base = glm.generic_limb_matmul(F._meta, a, b)
    monkeypatch.setattr(_kernels, "unroll_one_shot", lambda L, n_elems: True)
    forced = glm.generic_limb_matmul(F._meta, a, b)
    assert np.array_equal(np.asarray(base), np.asarray(forced))
