"""Finite-field linear algebra kernels.

Device replacement for the reference's _lapack_linalg/Numba layer
(reference: src/galois/_domains/_linalg.py). Strategy:

- GF(2): matmul as a float32 matmul + mod-2 — exact while the inner
  dimension K < 2^24 (f32 mantissa), which the call checks.
- GF(p), p < 2^32: balanced int8 digit planes, int32-accumulated dots
  (the analogue of the reference's exact-float BLAS trick,
  src/galois/_domains/_linalg.py:21-75).
- GF(2^m), GF(p^m) and limb fields: bit-, digit- and limb-plane matmuls
  (ops/_binary_matmul.py, _digit_matmul.py, _limb_matmul.py); anything
  else a lax.scan over the contraction axis using the field's multiply/add
  kernels (always exact).

Row-reduction / LU / inverse / solve / det use masked pivoting under lax
control flow so they stay jittable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import STORAGE_INT
from ._kernels import get_ops

__all__ = ["matmul", "row_reduce", "inv", "det", "solve", "matrix_rank",
           "lu_decompose", "plu_decompose"]


def _calc_mode(cls):
    mode = cls._mode
    if mode == "python-calculate":
        mode = cls._meta.default_ufunc_mode
    return mode


def matmul(A, B):
    """Matrix multiply of two FieldArrays with NumPy matmul semantics
    (1-D promotion, batched broadcasting)."""
    cls = type(A)
    meta = cls._meta
    a, b = A._data, B._data

    # NumPy 1-D promotion rules
    a_vec = A.ndim == 1
    b_vec = B.ndim == 1
    if A.ndim == 0 or B.ndim == 0:
        raise ValueError("matmul is not defined for 0-D inputs.")

    out = _matmul_data(meta, _calc_mode(cls), a, b, a_vec, b_vec)
    return cls._view(out, A._dtype)


def _t_nd(meta) -> int:
    """Trailing storage axes: 1 for digit storage; 0 for int and planar
    limb storage (the planar limb axis LEADS and rides as a batch axis)."""
    return 1 if meta.storage == "digits" else 0


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 5))
def _matmul_data(meta, mode, a, b, a_vec: bool, b_vec: bool):
    ops = get_ops(meta, mode)
    t_nd = _t_nd(meta)

    if a_vec:
        a = jnp.expand_dims(a, axis=-2 - t_nd)
    if b_vec:
        b = jnp.expand_dims(b, axis=-1 - t_nd)

    p, m = meta.characteristic, meta.degree

    if meta.storage == STORAGE_INT and m == 1:
        K = a.shape[-1]
        if p == 2:
            out = _gf2_matmul(a, b, K)
        else:
            out = _prime_matmul_planes(a, b, p, K)
    else:
        from ._binary_matmul import binary_matmul
        from ._binary_matmul import supports as bin_supports
        from ._digit_matmul import digit_matmul
        from ._digit_matmul import supports as dig_supports
        from ._limb_matmul import limb_matmul
        from ._limb_matmul import supports_any as limb_supports

        K = a.shape[-1 - t_nd]
        if bin_supports(meta, K):
            out = binary_matmul(meta, a, b)
        elif dig_supports(meta, K):
            out = digit_matmul(meta, a, b)
        elif limb_supports(meta):
            out = limb_matmul(meta, a, b)
        else:
            out = _generic_matmul(ops, meta, a, b)

    if a_vec:
        out = jnp.squeeze(out, axis=-2 - t_nd)
    if b_vec:
        out = jnp.squeeze(out, axis=-1 - t_nd)
    return out


def _gf2_matmul(a, b, K):
    """GF(2) matmul as an f32 dot of 0/1 operands (sums exact for
    K < 2^24); larger K is processed in blocks whose parities XOR
    together."""
    blk = 2**23
    acc = None
    for s in range(0, K, blk):
        e = min(K, s + blk)
        c = jnp.matmul(
            a[..., s:e].astype(jnp.float32),
            b[..., s:e, :].astype(jnp.float32),
            preferred_element_type=jnp.float32,
            # exact integer sums need full f32, never a TF32 pass
            precision=jax.lax.Precision.HIGHEST,
        )
        part = c.astype(jnp.int32) & 1
        acc = part if acc is None else acc ^ part
    return acc.astype(a.dtype)


def int8_matmul(a, b):
    """Exact a (..., M, K) @ b (..., K, N) of int8 operands, int32 sums.

    Every int8 dot of the library goes through here. On an H100 (JAX 0.9.0)
    XLA's Triton int8 GEMM returned wrong sums when K is not a multiple of
    4: for K = 2..15 at every shape tried, and for K = 49..63, 127, 255,
    511 and 1023 at large ones; every multiple of 4 from 4 to 2048 was
    exact (`python chip_smoke.py --probe dots`). So K is zero-padded to a
    multiple of 4; zero terms change no sum."""
    pad = -a.shape[-1] % 4
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
    return jnp.matmul(a, b, preferred_element_type=jnp.int32)


_PLANE_BITS = 8
_PLANE_BASE = 1 << _PLANE_BITS
_PLANE_MAXD = _PLANE_BASE // 2  # balanced digit magnitude bound (128)


def _balanced_planes(x, p, n_planes):
    """Signed balanced base-256 digit planes of the SYMMETRIC residue.

    x in [0, p) maps to x' = x - p*(x > p//2) with |x'| <= p/2 < 2^31, then
    x' = sum d_i 256^i with d_i in [-128, 127] — four s8 digits cover ANY
    p < 2^32 (vs five 7-bit digits), cutting a 31/32-bit prime's plane-pair
    matmuls from 25 to 16.

    All arithmetic is 32-bit: the symmetric residue of any p < 2^32 fits
    int32 (computed in u32 with two's-complement wrap, then bitcast)."""
    xu = x.astype(jnp.uint32)
    xs = jnp.where(xu > jnp.uint32(p // 2), xu - jnp.uint32(p), xu)
    xs = jax.lax.bitcast_convert_type(xs, jnp.int32)  # |xs| <= p/2 < 2^31
    out = []
    for _ in range(n_planes):
        # xs = 256 q + r, r in [0, 256): the digit is r, or r - 256 with a
        # carry into q. (xs - d) >> 8 would overflow int32 for |xs| near
        # 2^31, i.e. for p within 258 of 2^32.
        r = xs & 255
        up = (r >= 128).astype(jnp.int32)
        out.append((r - (up << 8)).astype(jnp.int8))
        xs = (xs >> 8) + up
    return out


def balanced_plane_count(p: int) -> int:
    """Smallest digit count whose all-127 value covers the symmetric-residue
    magnitude p/2 (primes within 0.4% of 2^32 need a 5th digit: the top
    balanced digit caps at +127, not +128)."""
    n_planes = 1
    while 127 * ((_PLANE_BASE**n_planes - 1) // (_PLANE_BASE - 1)) < p // 2:
        n_planes += 1
    return n_planes


def balanced_planes_np(x: np.ndarray, p: int) -> np.ndarray:
    """Host-side _balanced_planes: (n_planes, *x.shape) int8 NumPy stack,
    for precomputing a static matmul operand's planes at plan-build time."""
    xs = x.astype(np.int64)
    xs = np.where(xs > p // 2, xs - p, xs)
    out = []
    for _ in range(balanced_plane_count(p)):
        d = ((xs + 128) & 255) - 128
        out.append(d.astype(np.int8))
        xs = (xs - d) >> 8
    return np.stack(out)


def _prime_matmul_planes(a, b, p, K, a_planes=None, b_planes=None):
    """Exact GF(p) matmul, p < 2^32: balanced signed 8-bit plane
    decomposition onto int8 x int8 -> int32 dots (the integer analogue of
    the reference's exact-float BLAS trick, src/galois/_domains/_linalg.py:
    21-75). A static operand's planes can be passed precomputed
    (`a_planes`/`b_planes`, stacked int8 — the NTT plans ship their DFT
    tables this way so runtime extraction only pays for the data side)."""
    n_planes = balanced_plane_count(p)
    # int32 accumulation is exact while K*128^2 < 2^31
    max_block = (2**31 - 1) // (_PLANE_MAXD**2)
    # int64 extraction: values up to p-1 can exceed int32 for p near 2^32
    a_planes = (
        _balanced_planes(a, p, n_planes)
        if a_planes is None
        else [a_planes[i] for i in range(n_planes)]
    )
    b_planes = (
        _balanced_planes(b, p, n_planes)
        if b_planes is None
        else [b_planes[i] for i in range(n_planes)]
    )
    out_dt = (b if a is None else a).dtype
    # Deferred-mod fast path: each plane product magnitude is <= K*128^2 and
    # each shift < p, so when the worst-case weighted sum fits in int63 we
    # can accumulate every (signed) term raw and reduce mod p exactly once —
    # jnp's % takes the divisor's sign, so negative accumulators land in
    # [0, p) (one 64-bit mod per output instead of one per plane pair).
    if n_planes * n_planes * K * _PLANE_MAXD**2 * (p - 1) < 2**62:
        # Group pair products by diagonal s = i + j IN INT32 first (exact
        # while pairs_per_diag * Kb * 128^2 < 2^31), then weight/accumulate
        # the 2n-1 diagonal sums in int64: the convert+multiply+add runs on
        # 7 diagonals instead of 16 pair products.
        # Overall bound unchanged: sum_s dp(s)*K*128^2*(p-1) = the guard.
        kdiag = (2**31 - 1) // (_PLANE_MAXD**2 * n_planes)
        acc = None
        for s0 in range(0, K, kdiag):
            e0 = min(K, s0 + kdiag)
            diag = [None] * (2 * n_planes - 1)
            for i in range(n_planes):
                for j in range(n_planes):
                    blk = int8_matmul(a_planes[i][..., s0:e0], b_planes[j][..., s0:e0, :])
                    d = i + j
                    diag[d] = blk if diag[d] is None else diag[d] + blk
            for d, v in enumerate(diag):
                term = v.astype(jnp.int64) * pow(2, _PLANE_BITS * d, p)
                acc = term if acc is None else acc + term
        return (acc % p).astype(out_dt)
    acc = None
    for i in range(n_planes):
        for j in range(n_planes):
            shift = pow(2, _PLANE_BITS * (i + j), p)
            part = None
            for s in range(0, K, max_block):
                e = min(K, s + max_block)
                blk = int8_matmul(a_planes[i][..., s:e], b_planes[j][..., s:e, :])
                blk = (blk.astype(jnp.int64) % p)
                part = blk if part is None else (part + blk) % p
            # part, shift are both < p (p can approach 2^32), so part*shift
            # can exceed int63 and wrap. Split shift into 16-bit halves:
            # part*s_hi < 2^32*2^16 and (part*s_hi % p)*2^16 + part*s_lo
            # < 2^49, so every intermediate stays exact in int64.
            s_hi, s_lo = divmod(shift, 1 << 16)
            term = ((part * s_hi) % p * (1 << 16) + part * s_lo) % p
            acc = term if acc is None else (acc + term) % p
    return acc.astype(out_dt)


def _generic_matmul(ops, meta, a, b):
    """Scan over the contraction axis with exact field ops (any field)."""
    # int: a (..., M, K); planar limbs: a (w, ..., M, K) — the leading limb
    # axis broadcasts through the same trailing-axis code; digits keep a
    # trailing (m,) axis and need the offset branch below.
    if _t_nd(meta) == 0:
        a_k = jnp.moveaxis(a, -1, 0)        # (K, [w,] ..., M)
        b_k = jnp.moveaxis(b, -2, 0)        # (K, [w,] ..., N)

        def body(carry, xs):
            ak, bk = xs                      # ([w,] ..., M), ([w,] ..., N)
            prod = ops.multiply(ak[..., :, None], bk[..., None, :])
            return ops.add(carry, prod), None

        init = jnp.zeros(
            jnp.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1,) + b.shape[-1:]),
            dtype=a.dtype,
        )
        out, _ = jax.lax.scan(body, init, (a_k, b_k))
        return out
    else:
        w = meta.storage_width
        a_k = jnp.moveaxis(a, -2, 0)        # (K, ..., M, w)
        b_k = jnp.moveaxis(b, -3, 0)        # (K, ..., N, w)

        def body(carry, xs):
            ak, bk = xs
            prod = ops.multiply(ak[..., :, None, :], bk[..., None, :, :])
            return ops.add(carry, prod), None

        init_shape = jnp.broadcast_shapes(
            a.shape[:-2] + (1, w), b.shape[:-3] + (1,) + b.shape[-2:]
        )
        init = jnp.zeros(init_shape, dtype=a.dtype)
        out, _ = jax.lax.scan(body, init, (a_k, b_k))
        return out


# ----------------------------------------------------------------------
# Gaussian elimination family (int-storage fields; digit/limb fields use
# the same code through the ops object)
# ----------------------------------------------------------------------

def row_reduce(A, ncols=None):
    """Row-reduce to reduced row echelon form
    (reference: src/galois/_domains/_linalg.py:316-352).

    Small concrete matrices use exact host elimination (compile-free); large
    or traced inputs use the masked fixed-trip-count device kernel."""
    cls = type(A)
    if A.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {A.ndim}-D.")
    ncols = A.shape[1] if ncols is None else int(ncols)
    import jax

    if not isinstance(A._data, jax.core.Tracer) and A.size <= 4096:
        R, _, _ = _host_row_reduce(cls, np.asarray(A, dtype=object), ncols)
        return cls(R)
    out, _ = _row_reduce_data(cls._meta, _calc_mode(cls), A._data, ncols)
    return cls._view(out, A._dtype)


def _host_row_reduce(cls, Anp, ncols):
    """Exact host RREF. Returns (matrix, rank, pivot_cols)."""
    from ..fields._hostfield import get_host_field

    hf = get_host_field(cls._meta)
    M = [[int(v) for v in row] for row in Anp]
    rows = len(M)
    pivots = []
    r = 0
    for c in range(ncols):
        piv = next((i for i in range(r, rows) if M[i][c] != 0), None)
        if piv is None:
            continue
        M[r], M[piv] = M[piv], M[r]
        inv = hf.reciprocal(M[r][c])
        M[r] = [hf.multiply(v, inv) for v in M[r]]
        for i in range(rows):
            if i != r and M[i][c] != 0:
                f = M[i][c]
                M[i] = [hf.subtract(v, hf.multiply(f, w)) for v, w in zip(M[i], M[r])]
        pivots.append(c)
        r += 1
        if r == rows:
            break
    return np.array(M, dtype=object), r, pivots


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def _row_reduce_data(meta, mode, a, ncols: int):
    """Masked Gaussian elimination: fixed iteration count, no data-dependent
    control flow — jit/vmap/shard-safe."""
    ops = get_ops(meta, mode)
    M = a.shape[1] if meta.storage_first else a.shape[0]

    def one_col(state, j):
        a, pivot_row = state
        # find first row >= pivot_row with nonzero in col j
        col = _col(a, j, meta)
        nz = jnp.logical_not(ops.is_zero(col))
        rows = jnp.arange(M)
        candidates = jnp.where(jnp.logical_and(nz, rows >= pivot_row), rows, M)
        i = jnp.min(candidates)
        found = i < M

        def do_eliminate(a):
            # swap rows i and pivot_row
            ai = _row(a, i, meta)
            ap = _row(a, pivot_row, meta)
            a = _set_row(a, i, ap, meta)
            a = _set_row(a, pivot_row, ai, meta)
            # normalize pivot row (a scalar's storage broadcasts against the
            # row elementwise in every layout)
            piv = _elem(a, pivot_row, j, meta)
            inv = ops.reciprocal(piv)
            prow = ops.multiply(_row(a, pivot_row, meta), inv)
            a = _set_row(a, pivot_row, prow, meta)
            # eliminate all other rows
            factor = _col(a, j, meta)
            upd = ops.subtract(a, ops.multiply(_expand(factor, meta), _expand_rowb(prow, meta)))
            keep = rows == pivot_row
            a = jnp.where(_mask2(keep[:, None], meta), a, upd)
            return a

        a = jax.lax.cond(found, do_eliminate, lambda a: a, a)
        pivot_row = jnp.where(found, pivot_row + 1, pivot_row)
        return (a, pivot_row), None

    (a, pivot_row), _ = jax.lax.scan(one_col, (a, jnp.asarray(0)), jnp.arange(ncols))
    return a, pivot_row


# Layout-aware 2-D indexing helpers. Storage layouts of an (M, N) matrix:
#   int:    (M, N)       digits: (M, N, m)      planar limbs: (w, M, N)


def _row(a, i, meta):
    if meta.storage_first:
        return a[:, i]
    return a[i]


def _set_row(a, i, row, meta):
    if meta.storage_first:
        return a.at[:, i].set(row)
    return a.at[i].set(row)


def _col(a, j, meta):
    if meta.storage == STORAGE_INT:
        return a[:, j]
    if meta.storage_first:
        return a[:, :, j]
    return a[:, j, :]


def _set_col(a, j, col, meta):
    if meta.storage == STORAGE_INT:
        return a.at[:, j].set(col)
    if meta.storage_first:
        return a.at[:, :, j].set(col)
    return a.at[:, j, :].set(col)


def _elem(a, i, j, meta):
    if meta.storage == STORAGE_INT:
        return a[i, j]
    if meta.storage_first:
        return a[:, i, j]
    return a[i, j, :]


def _take_rows(a, idx, meta):
    return jnp.take(a, idx, axis=1 if meta.storage_first else 0)


def _expand(col, meta):
    # column storage -> broadcastable against the full matrix:
    # (M,) -> (M, 1); (M, w) -> (M, 1, w); planar (w, M) -> (w, M, 1)
    if meta.storage == STORAGE_INT or meta.storage_first:
        return col[..., None]
    return col[:, None, :]


def _expand_rowb(row, meta):
    # row storage -> broadcastable: (N,) -> (1, N); (N, m) -> (1, N, m);
    # planar (w, N) -> (w, 1, N)
    if meta.storage_first:
        return row[:, None, :]
    return row[None]


def _mask2(mask, meta):
    # (M, N) element mask -> aligned with the storage array. Trailing digit
    # axis needs an expansion; planar right-aligns under the leading w.
    if meta.storage == "digits":
        return mask[..., None]
    return mask


def matrix_rank(A) -> int:
    cls = type(A)
    import jax

    if not isinstance(A._data, jax.core.Tracer) and A.size <= 4096:
        _, rank, _ = _host_row_reduce(cls, np.asarray(A, dtype=object), A.shape[1])
        return rank
    _, pivots = _row_reduce_data(cls._meta, _calc_mode(cls), A._data, A.shape[1])
    return int(pivots)


def inv(A):
    """Matrix inverse via row-reducing [A | I]
    (reference: src/galois/_domains/_linalg.py:496-525)."""
    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    n = A.shape[0]
    import jax

    if not isinstance(A._data, jax.core.Tracer) and A.size <= 4096:
        Anp = np.asarray(A, dtype=object)
        AI = np.concatenate([Anp, np.eye(n, dtype=np.int64).astype(object)], axis=1)
        R, rank, _ = _host_row_reduce(cls, AI, n)
        if rank != n:
            raise np.linalg.LinAlgError("Matrix is singular and cannot be inverted.")
        return cls(R[:, n:])
    I = cls.Identity(n)
    meta = cls._meta
    col_ax = 2 if meta.storage_first else 1
    AI = jnp.concatenate([A._data, I._data], axis=col_ax)
    out, pivots = _row_reduce_data(meta, _calc_mode(cls), AI, n)
    if int(pivots) != n:
        raise np.linalg.LinAlgError("Matrix is singular and cannot be inverted.")
    if meta.storage == STORAGE_INT:
        inv_data = out[:, n:]
    elif meta.storage_first:
        inv_data = out[:, :, n:]
    else:
        inv_data = out[:, n:, :]
    return cls._view(inv_data, A._dtype)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _plu_data(meta, mode, a):
    """Masked in-place LAPACK-style factorization (device, jittable).

    Returns (lu, perm, swaps): ``lu`` holds the unit-lower factors below the
    diagonal and U on/above it; ``perm`` is the row-permutation vector with
    A[perm] = L @ U; ``swaps`` counts row exchanges (determinant sign).
    Fixed trip count with first-nonzero pivoting, matching the host path and
    the reference's plu_decompose_jit (src/galois/_domains/_linalg.py:387-426)
    semantics. Zero pivot columns are skipped, so singular inputs yield a U
    with zeros on the diagonal rather than an error.
    """
    ops = get_ops(meta, mode)
    if meta.storage_first:
        n, ncols = a.shape[1], a.shape[2]
    else:
        n, ncols = a.shape[0], a.shape[1]
    rows = jnp.arange(n)
    cols = jnp.arange(ncols)

    def one_col(state, j):
        a, perm, swaps = state
        colj = _col(a, j, meta)
        nz = jnp.logical_not(ops.is_zero(colj))
        cand = jnp.where(jnp.logical_and(nz, rows >= j), rows, n)
        i = jnp.min(cand)
        found = i < n
        i = jnp.where(found, i, j)
        # swap rows j <-> i via a full-row gather (no-op when i == j)
        idx = jnp.where(rows == j, i, jnp.where(rows == i, j, rows))
        a = _take_rows(a, idx, meta)
        perm = jnp.take(perm, idx)
        swaps = swaps + jnp.logical_and(found, i != j).astype(jnp.int32)
        piv = _elem(a, j, j, meta)
        inv_p = ops.reciprocal(piv)
        colj = _col(a, j, meta)
        below = rows > j
        factor = ops.multiply(colj, inv_p)
        rowj = _row(a, j, meta)
        upd = ops.subtract(a, ops.multiply(_expand(factor, meta), _expand_rowb(rowj, meta)))
        mask = jnp.logical_and(jnp.logical_and(below[:, None], cols[None, :] > j), found)
        a = jnp.where(_mask2(mask, meta), upd, a)
        # record the multipliers in column j below the diagonal
        newcol = ops._select(jnp.logical_and(below, found), factor, colj)
        a = _set_col(a, j, newcol, meta)
        return (a, perm, swaps), None

    init = (a, rows, jnp.asarray(0, jnp.int32))
    (a, perm, swaps), _ = jax.lax.scan(one_col, init, jnp.arange(min(n, ncols)))
    return a, perm, swaps


@functools.partial(jax.jit, static_argnums=(0, 1))
def _det_data(meta, mode, a):
    """Determinant on device: PLU, then (-1)^swaps * prod(diag(U))."""
    ops = get_ops(meta, mode)
    lu, _, swaps = _plu_data(meta, mode, a)
    n = a.shape[1] if meta.storage_first else a.shape[0]
    ar = jnp.arange(n)
    if meta.storage_first:
        diag = lu[:, ar, ar]                   # (w, n) planar
        diag = jnp.moveaxis(diag, 0, -1)       # (n, w) scan layout
        one = ops.one_like(diag[0])            # (w,) planar scalar

        def body(carry, d):
            return ops.multiply(carry, d), None
    else:
        diag = lu[ar, ar]  # (n,) or (n, m)
        one = ops.one_like(diag[0])

        def body(carry, d):
            return ops.multiply(carry, d), None

    prod, _ = jax.lax.scan(body, one, diag)
    odd = (swaps & 1) == 1
    return ops._select(odd, ops.negative(prod), prod)


_DEVICE_LINALG_CUTOFF = 4096


def _lu_split(cls, lu_data, perm, n):
    """Split the packed getrf output into (P, L, U) FieldArrays."""
    meta = cls._meta
    rows = jnp.arange(n)[:, None]
    ncols = lu_data.shape[2] if meta.storage_first else lu_data.shape[1]
    cols = jnp.arange(ncols)[None, :]
    lower = _mask2(rows > cols, meta)
    diag = _mask2(rows == cols, meta)
    zero = jnp.zeros_like(lu_data)
    ops = get_ops(meta, _calc_mode(cls))
    one = ops.one_like(lu_data)
    L = jnp.where(lower, lu_data, jnp.where(diag, one, zero))
    U = jnp.where(jnp.logical_not(lower), lu_data, zero)
    # P[perm[k], k] = 1  (A = P @ L @ U); built on device so the whole
    # decomposition is jit-safe (perm may be a tracer).
    oh = jnp.arange(n)[:, None] == jnp.asarray(perm)[None, :]
    dt = jnp.dtype(meta.internal_dtype)
    if meta.storage == STORAGE_INT:
        P_data = oh.astype(dt)
    elif meta.storage_first:
        P_data = (
            jnp.zeros((meta.storage_width, n, n), dtype=dt).at[0].set(oh.astype(dt))
        )
    else:
        P_data = (
            jnp.zeros((n, n, meta.storage_width), dtype=dt)
            .at[..., 0]
            .set(oh.astype(dt))
        )
    return cls._view(P_data), cls._view(L, None), cls._view(U, None)


def det(A):
    """Determinant via PLU: det = (-1)^swaps * prod(diag(U)).

    Small concrete matrices use exact host elimination; larger ones run the
    masked device kernel (reference: src/galois/_domains/_linalg.py:434-475).
    """
    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    n = A.shape[0]
    if n == 1:
        return A[0, 0]
    if not isinstance(A._data, jax.core.Tracer) and A.size <= _DEVICE_LINALG_CUTOFF:
        P, L, U, swaps = _plu(cls, A)
        diag = [U[i, i] for i in range(n)]
        out = diag[0]
        for d in diag[1:]:
            out = out * d
        if swaps % 2 == 1:
            out = -out
        return out
    out = _det_data(cls._meta, _calc_mode(cls), A._data)
    return cls._view(out, A._dtype)


def lu_decompose(A):
    cls = type(A)
    P, L, U = plu_decompose(A)
    if not np.array_equal(np.asarray(P), np.eye(A.shape[0], dtype=np.int64)):
        raise ValueError("The LU decomposition of 'A' does not exist. Use the PLU decomposition instead.")
    return L, U


def plu_decompose(A):
    cls = type(A)
    if A.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {A.ndim}-D.")
    if not isinstance(A._data, jax.core.Tracer) and A.size <= _DEVICE_LINALG_CUTOFF:
        P, L, U, swaps = _plu(cls, A)
        return P, L, U
    lu_data, perm, _ = _plu_data(cls._meta, _calc_mode(cls), A._data)
    return _lu_split(cls, lu_data, perm, A.shape[0])


def _plu(cls, A):
    """Host-orchestrated PLU with partial 'first nonzero' pivoting, exact
    field arithmetic (concrete shapes; small-matrix path)."""
    n = A.shape[0]
    Anp = np.asarray(A, dtype=object)
    from ..fields._hostfield import get_host_field

    hf = get_host_field(cls._meta)
    U = [[int(v) for v in row] for row in Anp]
    L = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    perm = list(range(n))
    swaps = 0
    for j in range(min(n, len(U[0]) if U else 0)):
        # pivot: first i >= j with U[i][j] != 0
        piv = None
        for i in range(j, n):
            if U[i][j] != 0:
                piv = i
                break
        if piv is None:
            continue
        if piv != j:
            U[j], U[piv] = U[piv], U[j]
            perm[j], perm[piv] = perm[piv], perm[j]
            for k in range(j):
                L[j][k], L[piv][k] = L[piv][k], L[j][k]
            swaps += 1
        inv_p = hf.reciprocal(U[j][j])
        for i in range(j + 1, n):
            if U[i][j] != 0:
                factor = hf.multiply(U[i][j], inv_p)
                L[i][j] = factor
                for k in range(len(U[i])):
                    U[i][k] = hf.subtract(U[i][k], hf.multiply(factor, U[j][k]))
    P = np.zeros((n, n), dtype=np.int64)
    for row, col in enumerate(perm):
        P[col, row] = 1
    return cls(P.tolist()), cls(L), cls(U), swaps


def solve(A, b):
    """Solve Ax = b (reference: src/galois/_domains/_linalg.py:528-548)."""
    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    Ainv = inv(A)
    return matmul(Ainv, b)
