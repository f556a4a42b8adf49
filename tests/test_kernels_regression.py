"""Regression tests for device kernel specializations:

- Mersenne-prime all-u32 multiply (ops/_kernels.py PrimeOps._mul_mersenne*)
- int8-matmul 4-step NTT plan vs the elementwise mixed-radix plan (ops/_ntt.py)
- chunked NTT contraction (memory-budgeted j-loop)
- two-level (sqrt-chunked) Horner polynomial evaluation (ops/_poly_eval.py)
"""

import numpy as np
import pytest


# ----------------------------------------------------------------------
# Mersenne multiply
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", [3, 7, 31, 127, 8191, 2**31 - 1])
def test_mersenne_multiply_matches_oracle(p):
    import jax

    import galois_tpu as g
    from galois_tpu.ops._kernels import get_ops

    GF = g.GF(p)
    ops = get_ops(GF._meta, "jit-calculate")
    assert ops._mersenne_e == p.bit_length()
    rng = np.random.default_rng(p)
    a = rng.integers(0, p, 5000, dtype=np.int64)
    b = rng.integers(0, p, 5000, dtype=np.int64)
    got = np.asarray(
        jax.jit(ops.multiply)(
            a.astype(GF._meta.internal_dtype), b.astype(GF._meta.internal_dtype)
        ),
        dtype=np.int64,
    )
    exp = ((a.astype(object) * b.astype(object)) % p).astype(np.int64)
    assert np.array_equal(got, exp)


def test_mersenne_multiply_corners():
    import galois_tpu as g
    from galois_tpu.ops._kernels import get_ops

    for p in (8191, 2**31 - 1):
        GF = g.GF(p)
        ops = get_ops(GF._meta, "jit-calculate")
        vals = [0, 1, 2, p - 2, p - 1, p // 2, p // 2 + 1]
        a = np.array([x for x in vals for _ in vals], dtype=np.int64)
        b = np.array(vals * len(vals), dtype=np.int64)
        got = np.asarray(
            ops.multiply(
                a.astype(GF._meta.internal_dtype), b.astype(GF._meta.internal_dtype)
            ),
            dtype=np.int64,
        )
        exp = ((a.astype(object) * b.astype(object)) % p).astype(np.int64)
        assert np.array_equal(got, exp), p


def test_non_mersenne_has_no_fast_path():
    import galois_tpu as g
    from galois_tpu.ops._kernels import get_ops

    for p in (5, 257, 65537, 2**31 - 19):
        ops = get_ops(g.GF(p)._meta, "jit-calculate")
        assert ops._mersenne_e is None, p


# ----------------------------------------------------------------------
# int8-matmul 4-step NTT plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q,n", [(97, 96), (257, 256), (12289, 4096), (3 * 2**30 + 1, 2048)])
def test_matmul_fft_plan_matches_elementwise(q, n):
    import galois_tpu as g
    from galois_tpu.ops._ntt import FFTPlan, MatmulFFTPlan, _fft_jit, _get_omega, _plan

    GF = g.GF(q)
    om = _get_omega(GF, n)
    plan = _plan(GF._meta, n, om, "jit-calculate")
    assert isinstance(plan, MatmulFFTPlan), "expected the matmul plan for this size"
    ref_plan = FFTPlan(GF._meta, n, om, "jit-calculate")
    x = np.random.default_rng(0).integers(0, q, n, dtype=np.int64)
    xs = x.astype(GF._meta.internal_dtype)
    got = np.asarray(_fft_jit(plan)(xs), dtype=np.int64)
    exp = np.asarray(ref_plan.transform(xs), dtype=np.int64)
    assert np.array_equal(got, exp)


def test_matmul_fft_plan_batched():
    import galois_tpu as g
    from galois_tpu.ops._ntt import MatmulFFTPlan, _fft_jit, _get_omega, _plan

    GF = g.GF(257)
    om = _get_omega(GF, 256)
    plan = _plan(GF._meta, 256, om, "jit-calculate")
    assert isinstance(plan, MatmulFFTPlan)
    x = np.random.default_rng(1).integers(0, 257, (3, 256), dtype=np.int64)
    xs = x.astype(GF._meta.internal_dtype)
    got = np.asarray(_fft_jit(plan)(xs), dtype=np.int64)
    for i in range(3):
        row = np.asarray(_fft_jit(plan)(xs[i]), dtype=np.int64)
        assert np.array_equal(got[i], row)


def test_prime_fft_skips_matmul_plan_when_unsplittable():
    import galois_tpu as g
    from galois_tpu.ops._ntt import FFTPlan, MatmulFFTPlan, _get_omega, _plan

    # 13 is prime and <= the base-DFT cutoff -> elementwise plan
    GF = g.GF(53)
    om = _get_omega(GF, 13)
    plan = _plan(GF._meta, 13, om, "jit-calculate")
    assert not isinstance(plan, MatmulFFTPlan)
    assert isinstance(plan, FFTPlan)


# ----------------------------------------------------------------------
# Chunked contraction
# ----------------------------------------------------------------------

def test_chunked_contraction_matches_unchunked():
    import galois_tpu as g
    from galois_tpu.ops import _ntt as M

    p = 2**64 - 2**32 + 1
    GFg = g.GF(p)
    om = M._get_omega(GFg, 512)
    plan = M.FFTPlan(GFg._meta, 512, om, "jit-calculate")
    from galois_tpu.fields._array import _ints_to_storage_np, _storage_to_ints

    vals = np.array([pow(5, i, p) for i in range(512)], dtype=object)
    xs = _ints_to_storage_np(GFg._meta, vals)
    unchunked = _storage_to_ints(GFg._meta, np.asarray(plan.transform(xs)))
    old = M.FFTPlan._CONTRACT_BUDGET
    try:
        M.FFTPlan._CONTRACT_BUDGET = 64  # force maximal chunking
        plan2 = M.FFTPlan(GFg._meta, 512, om, "jit-calculate")
        chunked = _storage_to_ints(GFg._meta, np.asarray(plan2.transform(xs)))
    finally:
        M.FFTPlan._CONTRACT_BUDGET = old
    assert np.array_equal(np.asarray(unchunked, dtype=object), np.asarray(chunked, dtype=object))


# ----------------------------------------------------------------------
# Two-level Horner
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# Goldilocks int8-plane matmul
# ----------------------------------------------------------------------

GOLD_P = 2**64 - 2**32 + 1


def test_goldilocks_matmul_matches_object_oracle():
    import galois_tpu as g

    GF = g.GF(GOLD_P)
    A = GF.Random((8, 33), seed=1)
    B = GF.Random((33, 5), seed=2)
    got = np.asarray(A @ B, dtype=object)
    exp = (np.asarray(A, dtype=object) @ np.asarray(B, dtype=object)) % GOLD_P
    assert np.array_equal(got, exp)


def test_goldilocks_matmul_corners():
    import galois_tpu as g

    GF = g.GF(GOLD_P)
    A = GF(np.full((3, 7), GOLD_P - 1, dtype=object))
    B = GF(np.full((7, 3), GOLD_P - 1, dtype=object))
    got = np.asarray(A @ B, dtype=object)
    exp = (np.asarray(A, dtype=object) @ np.asarray(B, dtype=object)) % GOLD_P
    assert np.array_equal(got, exp)


def test_goldilocks_matmul_fft_plan():
    import galois_tpu as g
    from galois_tpu.fields._array import _ints_to_storage_np, _storage_to_ints
    from galois_tpu.ops import _ntt as M

    GF = g.GF(GOLD_P)
    N = 1024
    om = M._get_omega(GF, N)
    plan = M._plan(GF._meta, N, om, "jit-calculate")
    assert isinstance(plan, M.MatmulFFTPlan)
    ref = M.FFTPlan(GF._meta, N, om, "jit-calculate")
    vals = np.array([pow(5, i, GOLD_P) for i in range(N)], dtype=object)
    xs = _ints_to_storage_np(GF._meta, vals)
    got = _storage_to_ints(GF._meta, np.asarray(M._fft_jit(plan)(xs)))
    exp = _storage_to_ints(GF._meta, np.asarray(ref.transform(xs)))
    assert np.array_equal(np.asarray(got, dtype=object), np.asarray(exp, dtype=object))


# ----------------------------------------------------------------------
# Two-level Horner
# ----------------------------------------------------------------------

@pytest.mark.parametrize("deg", [62, 63, 64, 65, 100, 255])
def test_poly_eval_chunked_boundary(deg):
    import galois_tpu as g
    from galois_tpu.fields._hostfield import get_host_field
    from galois_tpu.polys import _hostpoly as hp

    GF = g.GF(2**13 - 1)
    rng = np.random.default_rng(deg)
    coeffs = [int(c) for c in rng.integers(1, 2**13 - 1, deg + 1)]
    f = g.Poly(coeffs, field=GF)
    x = GF.Random(257, seed=deg)
    got = np.asarray(f(x), dtype=np.int64)
    hf = get_host_field(GF._meta)
    asc = f._asc()
    exp = np.array([hp.evaluate(hf, asc, int(v)) for v in np.asarray(x)], dtype=np.int64)
    assert np.array_equal(got, exp)


# ----------------------------------------------------------------------
# Overflow regressions
# ----------------------------------------------------------------------

def test_oddext_digit_accumulator_no_u64_wrap():
    """GF(p^2) with p near 2^32: m*(p-1)^2 >= 2^64 wraps a u64 accumulator
    unless partial products are reduced mod p first."""
    import galois_tpu as g

    p = 4294966297
    r = 2
    while pow(r, (p - 1) // 2, p) == 1:
        r += 1
    poly = g.Poly([1, 0, (-r) % p], field=g.GF(p))
    GF = g.GF(p**2, irreducible_poly=poly)
    rng = np.random.default_rng(1)
    for _ in range(5):
        a0, a1 = (int(v) for v in rng.integers(0, p, 2))
        b0, b1 = (int(v) for v in rng.integers(0, p, 2))
        x = GF(a0 + a1 * p)
        y = GF(b0 + b1 * p)
        # (a0 + a1 t)(b0 + b1 t), t^2 = r
        e0 = (a0 * b0 + r * a1 * b1) % p
        e1 = (a0 * b1 + a1 * b0) % p
        assert int(x * y) == e0 + e1 * p
    x = GF(p**2 - 1)
    a0 = a1 = p - 1
    assert int(x * x) == (a0 * a0 + r * a1 * a1) % p + ((2 * a0 * a1) % p) * p


def test_prime_matmul_planes_slow_path_no_int64_wrap():
    """p > ~3e9 with large K: the slow path's part*shift product exceeded
    int63 and wrapped. Exercise the multi-block slow path."""
    import galois_tpu as g

    p = 3870334753
    GF = g.GF(p)
    K = 774398
    rng = np.random.default_rng(0)
    a = rng.integers(0, p, size=(1, K), dtype=np.int64)
    b = rng.integers(0, p, size=(K, 1), dtype=np.int64)
    got = int((GF(a) @ GF(b))[0, 0])
    exp = int(sum(int(x) * int(y) for x, y in zip(a[0], b[:, 0])) % p)
    assert got == exp


def test_device_charpoly_matches_host_berkowitz():
    """Device Hessenberg + minor-recurrence char poly (ops/_charpoly.py)
    agrees with the host Berkowitz loop across fields and shapes,
    including rank-deficient matrices."""
    import galois_tpu as g
    from galois_tpu.ops import _charpoly

    for order, seed in [(2, 1), (31, 2), (2**8, 3), (3**3, 4)]:
        F = g.GF(order)
        for n in [1, 2, 4, 7]:
            A = F.Random((n, n), seed=seed * 10 + n)
            host = A.characteristic_poly()
            dev = _charpoly.charpoly_data(F._meta, F._mode, A._data)
            assert [int(x) for x in np.asarray(dev)[::-1]] == [
                int(c) for c in host.coefficients()
            ], (order, n)
    F = g.GF(31)
    B = F([[1, 2, 3, 4], [1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 7, 8]])
    dev = _charpoly.charpoly_data(F._meta, F._mode, B._data)
    assert [int(x) for x in np.asarray(dev)[::-1]] == [
        int(c) for c in B.characteristic_poly().coefficients()
    ]


def test_device_charpoly_large_det_crosscheck():
    """Above the 4096-element cutoff the device path is selected; verify
    p(x0) == det(x0 I - A) at random scalars (evaluation cross-check)."""
    import galois_tpu as g

    F = g.GF(2**8)
    A = F.Random((96, 96), seed=77)
    p = A.characteristic_poly()
    assert p.degree == 96
    for x0 in [F(3), F(200)]:
        M = F.Identity(96) * x0 - A
        assert int(p(x0)) == int(np.linalg.det(M))


def test_goldilocks_sqrt_and_tonelli_shanks():
    """Tonelli-Shanks is now fori_loop-based (S=32 for Goldilocks unrolled
    was a compile-time cliff); checks q = 1 mod 8 fields of each storage."""
    import galois_tpu as g

    p = 2**64 - 2**32 + 1
    F = g.GF(p)
    a = F([3, 12345, 0, p - 2])
    sq = a * a
    r = sq.sqrt()
    assert all(int(x) * int(x) % p == int(s) for x, s in zip(r, sq))
    G = g.GF(17)
    b = G([2, 4, 8, 9, 13, 15, 16, 0, 1])
    rb = (b * b).sqrt()
    assert all(int(x) * int(x) % 17 == int(s) for x, s in zip(rb, b * b))


def test_device_minimal_poly_krylov():
    """Device Krylov minimal poly (ops/_minpoly.py): annihilates A, divides
    the char poly, and recovers block-diagonal lcm structure."""
    import galois_tpu as g
    from galois_tpu._polymorphic import lcm

    for order in [31, 2**8, 2]:
        F = g.GF(order)
        A = F.Random((40, 40), seed=3)
        mp = A.minimal_poly()
        assert np.count_nonzero(np.asarray(mp(A, elementwise=False))) == 0
        q, r = divmod(A.characteristic_poly(), mp)
        assert r == 0 or (r.degree == 0 and int(r.coeffs[0]) == 0)
    F = g.GF(7)
    B = F.Random((6, 6), seed=9)
    host_mp = B.minimal_poly()  # under the device cutoff -> host path
    Mbig = np.zeros((40, 40), dtype=int)
    Mbig[:6, :6] = np.asarray(B, dtype=np.int64)
    for i in range(6, 40):
        Mbig[i, i] = 1
    mp_big = F(Mbig).minimal_poly()
    assert mp_big == lcm(host_mp, g.Poly([1, 6], field=F))


def test_trivial_d1_cyclic_code_construction():
    """d=1 codes have g(x)=1: G must be the identity with no parity block
    (crashed with IndexError before the full-matrix run caught it)."""
    import galois_tpu as g

    bch = g.BCH(31, 31)
    assert bch.d == 1 and bch.k == 31
    G = np.asarray(bch.G, dtype=np.int64)
    assert np.array_equal(G, np.eye(31, dtype=np.int64))
    m = g.GF2.Random((2, 31), seed=1)
    c = bch.encode(m)
    assert np.array_equal(np.asarray(c), np.asarray(m))


def test_recursive_matmul_fft_plan():
    """Factors above 4096 expand into recursive 6-step sub-plans (bit-exact
    vs the elementwise reference); factors <= 4096 stay direct matmuls."""
    import galois_tpu as g
    from galois_tpu.ops._ntt import MatmulFFTPlan, _get_omega, _plan, field_fft

    F = g.GF(3 * 2**30 + 1)
    # n2 = 8192 > 4096 forces a sub-plan
    pl = MatmulFFTPlan(F._meta, 2**16, _get_omega(F, 2**16), "jit-calculate", 8)
    assert pl.sub2 is not None and pl.sub1 is None
    x = F.Random(2**16, seed=1)
    X = pl.transform(x._data, pl.device_tables())
    assert np.array_equal(np.asarray(X), np.asarray(field_fft(x)))
    # standard sizes keep the direct two-matmul form
    pl24ish = _plan(F._meta, 2**18, _get_omega(F, 2**18), "jit-calculate")
    assert pl24ish.sub1 is None and pl24ish.sub2 is None


def test_barrett_u32_mulmod_corners():
    """One-shot u32 Barrett multiply (ops/_kernels.py::_mulmod_u32): the f32
    quotient estimate must stay within the +-p correction margin at the range
    corners — p just above 2^16, a 31-bit NTT prime, and the largest 32-bit
    prime — including unreduced operands and near-multiple products."""
    import jax
    import jax.numpy as jnp

    import galois_tpu as g
    from galois_tpu.ops._kernels import _mulmod_u32

    rng = np.random.default_rng(99)
    for p in (65537, 65551, 2013265921, 2147483659, 4294967291):
        a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        a[:3] = [p - 1, 2**32 - 1, 0]
        b[:3] = [p - 1, 2**32 - 1, p - 1]
        got = np.asarray(
            jax.jit(lambda x, y: _mulmod_u32(x, y, p))(jnp.asarray(a), jnp.asarray(b)),
            dtype=np.uint64,
        )
        want = (a.astype(np.uint64) * b.astype(np.uint64)) % p
        assert np.array_equal(got, want), p


def test_binary_ext_two_word_clmul_corners():
    """GF(2^m) m in 17..32: the (lo, hi) two-word mask-ladder clmul and
    constant-fold reduction against a python bit-twiddling oracle."""
    import jax
    import jax.numpy as jnp

    import galois_tpu as g
    from galois_tpu.ops._kernels import get_ops

    def pymul(x, y, m, fp):
        acc = 0
        while y:
            if y & 1:
                acc ^= x
            y >>= 1
            x <<= 1
        for i in range(2 * m - 2, m - 1, -1):
            if (acc >> i) & 1:
                acc ^= fp << (i - m)
        return acc

    rng = np.random.default_rng(7)
    for m in (17, 24, 32):
        GF = g.GF(2**m)
        ops = get_ops(GF._meta, "jit-calculate")
        f = int(GF.irreducible_poly)
        a = rng.integers(0, 2**m, 512, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**m, 512, dtype=np.uint64).astype(np.uint32)
        a[:2] = [2**m - 1, 1]
        b[:2] = [2**m - 1, 2**m - 1]
        got = np.asarray(jax.jit(ops.multiply)(jnp.asarray(a), jnp.asarray(b)), dtype=np.uint64)
        want = np.array([pymul(int(x), int(y), m, f) for x, y in zip(a, b)], dtype=np.uint64)
        assert np.array_equal(got, want), m


def test_oddext_digit_addsub_p_above_2_31():
    """Digit add/sub for GF(p^m) with p > 2^31 must not wrap u32 sums
    (review finding: A+B and A+(p-B) exceed 2^32)."""
    import galois_tpu as g
    from galois_tpu.fields._hostfield import get_host_field

    p = 2147483659
    c = next(c for c in range(2, 60) if g.kronecker_symbol(c, p) == -1)
    f = g.Poly([1, 0, (-c) % p], field=g.GF(p))
    GF = g.GF(p**2, irreducible_poly=f)
    hf = get_host_field(GF._meta)
    a = GF.Random((32,), seed=1)
    b = GF.Random((32,), seed=2)
    s_, d_, n_ = a + b, a - b, -a
    for k in range(32):
        assert hf.add(int(a[k]), int(b[k])) == int(s_[k])
        assert hf.subtract(int(a[k]), int(b[k])) == int(d_[k])
        assert hf.negative(int(a[k])) == int(n_[k])
