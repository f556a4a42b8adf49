"""Int8-plane matmuls for limb-storage prime fields (Goldilocks, BLS12-381).

Limb-storage (4 x uint16) matrices cannot ride the int/float paths in
ops/_linalg.py, and the generic scan contraction is latency-bound. For
p = 2^64 - 2^32 + 1 the 64-bit values are decomposed into ten 7-bit int8
planes, all 100 plane pairs run as exact int8 -> int32 matmuls, the pair
products are grouped by diagonal s = i + j (19 int32 sums, each < 2^31 for
block-K <= 13315), and the weighted sum  X = sum_s D_s * (2^(7s) mod p)  is
reduced with the same 2^64 === 2^32 - 1 identity as GoldilocksOps
(ops/_kernels.py) in u64 lanes — the matmuls do all the O(M K N) work; the
combine is O(M N).

This is the integer analogue of the reference's exact-float BLAS trick for
prime fields (reference: src/galois/_domains/_linalg.py:21-75), extended to a
64-bit field the reference can only handle in object dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ._linalg import int8_matmul

GOLD_P = 2**64 - 2**32 + 1
_M32 = (1 << 32) - 1
_N_PLANES = 10  # ceil(64 / 7)
# worst diagonal has 10 plane pairs; keep D_s < 2^31 exactly
_MAX_BLOCK_K = (2**31 - 1) // (127 * 127 * _N_PLANES)


def supports(meta) -> bool:
    return (
        meta.storage == "limbs"
        and meta.is_prime_field
        and meta.characteristic == GOLD_P
        and meta.storage_width == 4
    )


def _to_u64(a):
    # planar limbs: (4, ...) leading axis
    aw = a.astype(jnp.uint64)
    return aw[0] | (aw[1] << 16) | (aw[2] << 32) | (aw[3] << 48)


def _from_u64(x, dtype):
    out = jnp.stack(
        [x & 0xFFFF, (x >> 16) & 0xFFFF, (x >> 32) & 0xFFFF, (x >> 48) & 0xFFFF],
        axis=0,
    )
    return out.astype(dtype)


def _canon(x):
    return jnp.where(x >= jnp.uint64(GOLD_P), x - jnp.uint64(GOLD_P), x)


def _gold_add(x, y):
    lo = x + y
    carried = lo < x  # wrapped past 2^64 = 2^32 - 1 (mod p)
    return _canon(jnp.where(carried, lo + jnp.uint64(_M32), lo))


def _gold_mul_small(d, w: int):
    """(d * w) mod p for d < 2^32 (u64 array) and constant w < p."""
    m32 = jnp.uint64(_M32)
    y0 = w & _M32
    y1 = w >> 32
    z00 = d * jnp.uint64(y0)  # < 2^64
    z01 = d * jnp.uint64(y1)
    lo = z00 + ((z01 & m32) << 32)
    carry = (lo < z00).astype(jnp.uint64)
    hi = (z01 >> 32) + carry  # < 2^32
    # n = hi*2^64 + lo; hi < 2^32 so h1 = 0 and n mod p = lo + hi*(2^32-1)
    u = hi * m32  # < 2^64
    r = lo + u
    carried = r < lo
    r = jnp.where(carried, r + m32, r)  # wrap adds 2^64 = +(2^32-1) mod p
    return _canon(r)


def goldilocks_matmul(meta, a, b):
    """a: (4, ..., M, K), b: (4, ..., K, N) planar uint16 limbs ->
    (4, ..., M, N)."""
    au = _to_u64(a)  # (..., M, K)
    bu = _to_u64(b)  # (..., K, N)
    K = au.shape[-1]
    acc = None
    for k0 in range(0, K, _MAX_BLOCK_K):
        k1 = min(K, k0 + _MAX_BLOCK_K)
        ab = au[..., k0:k1]
        bb = bu[..., k0:k1, :]
        a_planes = [((ab >> (7 * i)) & jnp.uint64(127)).astype(jnp.int8) for i in range(_N_PLANES)]
        b_planes = [((bb >> (7 * j)) & jnp.uint64(127)).astype(jnp.int8) for j in range(_N_PLANES)]
        diag = [None] * (2 * _N_PLANES - 1)
        for i in range(_N_PLANES):
            for j in range(_N_PLANES):
                c = int8_matmul(a_planes[i], b_planes[j])
                s = i + j
                diag[s] = c if diag[s] is None else diag[s] + c
        blk = None
        for s, d in enumerate(diag):
            term = _gold_mul_small(d.astype(jnp.uint64), pow(2, 7 * s, GOLD_P))
            blk = term if blk is None else _gold_add(blk, term)
        acc = blk if acc is None else _gold_add(acc, blk)
    return _from_u64(acc, a.dtype)


# ---------------------------------------------------------------------------
# Generic limb-prime matmul: any GF(p) with planar base-2^16 limb storage
# (BLS12-381 scalar field and friends). Same digit-plane strategy as the
# Goldilocks path above, generalized: the 16L-bit operands are split into
# D = ceil(16L/7) exact 7-bit int8 digit planes, all D^2 plane pairs run as
# int8 -> int32 matmuls grouped by diagonal s = i + j, the diagonal sums
# are scattered into base-2^16 columns of the exact 2L(+eps)-limb integer
# product, high limbs are folded down with 2^(16*(2L-1)) mod p, and one
# Barrett reduction (LimbPrimeOps._barrett_t) lands the result in [0, p).
# The matmuls do all O(M K N) work; the combine is O(D^2) elementwise on the
# (M, N) output only. (Integer analogue of the reference's exact-float
# BLAS trick, src/galois/_domains/_linalg.py:21-75, for fields the reference
# can only touch in object dtype.)
# ---------------------------------------------------------------------------

_LIMB_BITS = 16
_MASK16 = (1 << 16) - 1


def supports_generic(meta) -> bool:
    return meta.storage == "limbs" and meta.is_prime_field


_DIGIT_BITS = 8  # biased 8-bit digits (below): 2L planes instead of
# ceil(16L/7), a 25% MAC cut for 16-limb fields. Unsigned bytes ride
# s8 x s8 dots via the quantization zero-point trick: store d - 128 in
# int8 and add the rank-1 corrections 128*rowsum + 128*colsum + K*128^2
# to each diagonal after the matmuls.


def _digit_planes8(limbs, L: int):
    """Planar u16 limb list (u32 planes) -> 2L biased int8 byte planes.

    Byte t of the integer is (limb[t//2] >> 8*(t%2)) & 255; the stored
    plane is byte - 128 (int8). Byte windows never straddle limbs."""
    out = []
    for t in range(2 * L):
        v = (limbs[t // 2] >> (8 * (t % 2))) & 255
        out.append((v.astype(jnp.int32) - 128).astype(jnp.int8))
    return out


def _kblk_for(D: int) -> int:
    """K-block bound: true (unsigned-digit) diagonal sums must stay < 2^32;
    worst diagonal has <= D pairs of byte products <= 255^2."""
    return min(2048, max(1, (2**32 - 1) // (255 * 255 * D)))


def _glm_core(ops, meta, a, b, mode: str):
    """Chunk the output columns so the int32 digit-product intermediates
    stay bounded: at N = M = 2048 (the BLS 2^22 NTT side) the unchunked
    (M, D*N) int32 product is ~620 MB live per A-digit, several GB in
    all. Chunks run under lax.map so
    only ONE chunk's intermediates are live at a time — a Python loop of
    independent chunks let the scheduler overlap them and still OOM'd.

    A's digit planes and their column sums are extracted ONCE here and
    captured by the chunk body — the per-chunk re-extraction wrote the
    same ~0.5 GB of int8 planes 16x at the 2^24 side shape."""
    L = meta.storage_width
    D = -(-(_LIMB_BITS * L) // _DIGIT_BITS)
    M, N = a.shape[-2], b.shape[-1]
    K = a.shape[-1]
    nc = max(128, (128 * 2**20) // max(1, 4 * M * D))
    nc = 1 << (nc.bit_length() - 1)  # power of two: divides any pow2 N
    if N <= nc:
        return _glm_core_block(ops, meta, a, b, mode)
    au = [a[k].astype(jnp.uint32) for k in range(L)]
    kblk = _kblk_for(D)
    a_pre = []
    for k0 in range(0, K, kblk):
        k1 = min(K, k0 + kblk)
        a_pl = _digit_planes8([x[:, k0:k1] for x in au], L)
        cs = [jnp.sum(p, axis=1, dtype=jnp.int32) for p in a_pl]
        a_pre.append((a_pl, cs))
    if N % nc == 0:
        nch = N // nc
        bs = jnp.moveaxis(b.reshape(b.shape[:-1] + (nch, nc)), -2, 0)
        out = jax.lax.map(
            lambda bb: _glm_core_block(ops, meta, a, bb, mode, a_pre=a_pre), bs
        )
        return jnp.moveaxis(out, 0, -2).reshape(out.shape[1:-1] + (N,))
    outs = [
        _glm_core_block(ops, meta, a, b[..., n0 : min(N, n0 + nc)], mode, a_pre=a_pre)
        for n0 in range(0, N, nc)
    ]
    return jnp.concatenate(outs, axis=-1)


def _glm_core_block(ops, meta, a, b, mode: str, a_pre=None):
    """Unbatched core: a (L, M, K) @ b (L, K, N) planar u16 -> (L, M, N).

    One stacked int8 matmul per (K-block, A-digit): A_i (M, Kb) times
    the j-concatenated B digits (Kb, D*N) — D matmuls per block instead of
    D^2 (an unrolled D^2-matmul graph for 16-limb fields is a compile-time
    cliff, see CLAUDE.md). Digits are biased bytes (d - 128 in int8, see
    _digit_planes8): after the matmuls each diagonal gets the rank-1
    zero-point corrections 128*colsum(A) + 128*rowsum(B) + pairs*Kb*128^2,
    computed exactly in u32 wrap arithmetic (true unsigned diagonal sums
    are < 2^32 for Kb <= 2048). Diagonals scatter into base-2^16 columns
    of the exact integer product, high limbs fold down with
    2^(16*(2L-1)) mod p, and one Barrett reduction (LimbPrimeOps.
    _barrett_t) lands in [0, p)."""
    from ..fields._meta import int_to_limbs

    L = meta.storage_width
    D = 2 * L
    M, K = a.shape[-2], a.shape[-1]
    N = b.shape[-1]
    from ._kernels import unroll_one_shot

    unroll = unroll_one_shot(L, M * N)  # the combine is a one-shot site

    au = [a[k].astype(jnp.uint32) for k in range(L)] if a_pre is None else None
    bu = [b[k].astype(jnp.uint32) for k in range(L)]

    kblk = _kblk_for(D)
    # top contribution sits at bit 8*(2D-2) and spans +32 bits
    W16 = -(-(_DIGIT_BITS * (2 * D - 2) + 32) // _LIMB_BITS) + 1

    cols = None
    for blk_i, k0 in enumerate(range(0, K, kblk)):
        k1 = min(K, k0 + kblk)
        kb = k1 - k0
        if a_pre is None:
            a_pl = _digit_planes8([x[:, k0:k1] for x in au], L)
            cs_pre = None
        else:
            a_pl, cs_pre = a_pre[blk_i]
        b_pl = _digit_planes8([x[k0:k1, :] for x in bu], L)
        nD = len(a_pl)
        Bt = jnp.stack(b_pl, axis=1).reshape(kb, nD * N)  # (Kb, D*N)
        acc = jnp.zeros((M, 2 * nD - 1, N), jnp.int32)
        for i in range(nD):
            prod = int8_matmul(a_pl[i], Bt)
            acc = jax.lax.dynamic_update_slice_in_dim(
                acc,
                jax.lax.dynamic_slice_in_dim(acc, i, nD, axis=1)
                + prod.reshape(M, nD, N),
                i,
                axis=1,
            )
        # zero-point corrections: colsum(A'_i) (M,), rowsum(B'_j) (N,)
        # dtype pinned: under x64 jnp.sum(int32) widens to int64 (NumPy
        # semantics) and a 64-bit bitcast to u32 would grow a trailing axis
        cs = (
            [jnp.sum(a_pl[i], axis=1, dtype=jnp.int32) for i in range(nD)]
            if cs_pre is None
            else cs_pre
        )  # (M,)
        rs = [jnp.sum(b_pl[j], axis=0, dtype=jnp.int32) for j in range(nD)]  # (N,)
        blk_cols = [None] * W16
        for s in range(2 * nD - 1):
            i_lo, i_hi = max(0, s - (nD - 1)), min(nD - 1, s)
            n_pairs = i_hi - i_lo + 1
            cs_sum = cs[i_lo]
            rs_sum = rs[s - i_lo]
            for i in range(i_lo + 1, i_hi + 1):
                cs_sum = cs_sum + cs[i]
                rs_sum = rs_sum + rs[s - i]
            # true diag = P + 128*(cs_sum + rs_sum) + pairs*Kb*128^2, exact
            # in u32 wrap arithmetic since the true value is < 2^32
            corr = (
                jax.lax.bitcast_convert_type(cs_sum[:, None] + rs_sum[None, :], jnp.uint32)
                << 7
            ) + jnp.uint32(n_pairs * kb * 16384)
            v = jax.lax.bitcast_convert_type(acc[:, s, :], jnp.uint32) + corr
            q, r16 = divmod(_DIGIT_BITS * s, _LIMB_BITS)
            v0 = (v & _MASK16) << r16          # < 2^31
            v1 = (v >> _LIMB_BITS) << r16      # < 2^31
            parts = (
                (q, v0 & _MASK16),
                (q + 1, (v0 >> _LIMB_BITS) + (v1 & _MASK16)),
                (q + 2, v1 >> _LIMB_BITS),
            )
            for qq, pv in parts:
                if qq < W16:
                    blk_cols[qq] = pv if blk_cols[qq] is None else blk_cols[qq] + pv
        zero = jnp.zeros((M, N), jnp.uint32)
        blk_cols = [zero if c is None else c for c in blk_cols]
        blk_cols = ops._carry_norm_t(blk_cols)  # sums < 2^21 -> planes < 2^16
        if cols is None:
            cols = blk_cols
        else:
            cols = ops._carry_norm_t([x + y for x, y in zip(cols, blk_cols)])

    # fold limbs at/above 2L-1 down so the Barrett precondition x < b^(2L)
    # holds with headroom
    top = 2 * L - 1
    while len(cols) > top:
        hi, lo = cols[top:], list(cols[:top])
        c_fold = np.asarray(
            int_to_limbs(pow(2, _LIMB_BITS * top, meta.characteristic), L)
        )
        folded = list(ops._mul_const_t(hi, c_fold, unroll=unroll))  # normalized planes
        width = max(len(lo), len(folded))
        zero = jnp.zeros((M, N), jnp.uint32)
        lo += [zero] * (width - len(lo))
        folded += [zero] * (width - len(folded))
        cols = ops._carry_norm_t([x + y for x, y in zip(lo, folded)])

    zero = jnp.zeros((M, N), jnp.uint32)
    cols = list(cols) + [zero] * (2 * L - len(cols))
    r = ops._barrett_t(cols[: 2 * L], unroll=unroll)
    return jnp.stack([jnp.broadcast_to(x, (M, N)) for x in r], axis=0).astype(a.dtype)


def generic_limb_matmul(meta, a, b, mode: str = "jit-calculate"):
    """a: (L, ..., M, K), b: (L, ..., K, N) planar uint16 limbs of a
    large-prime field -> (L, ..., M, N), exact mod p. Leading batch axes
    (after the limb axis) broadcast; a single-sided batch folds into the
    matmul's M or N axis (one big matmul, no vmap unrolling)."""
    from ._kernels import get_ops

    ops = get_ops(meta, mode)
    nb_a, nb_b = a.ndim - 3, b.ndim - 3
    if nb_a <= 0 and nb_b <= 0:
        return _glm_core(ops, meta, a, b, mode)
    if nb_a <= 0:
        # b batched: C[t] = a @ b[t] -> concatenate b's batch along N
        L, K, N = b.shape[0], b.shape[-2], b.shape[-1]
        bt = np.prod(b.shape[1:-2], dtype=int)
        b2 = jnp.moveaxis(b.reshape(L, bt, K, N), 2, 1).reshape(L, K, bt * N)
        out = _glm_core(ops, meta, a, b2, mode)
        M = a.shape[-2]
        out = jnp.moveaxis(out.reshape(L, M, bt, N), 2, 1)
        return out.reshape(b.shape[:-2] + (M, N))
    if nb_b <= 0:
        # a batched: C[t] = a[t] @ b -> concatenate a's batch along M
        L, M, K = a.shape[0], a.shape[-2], a.shape[-1]
        at = np.prod(a.shape[1:-2], dtype=int)
        a2 = a.reshape(L, at * M, K)
        out = _glm_core(ops, meta, a2, b, mode)
        N = b.shape[-1]
        return out.reshape(a.shape[:-1] + (N,))
    # both batched: broadcast batch dims and vmap the core over one flat axis
    bshape = jnp.broadcast_shapes(a.shape[1:-2], b.shape[1:-2])
    L = a.shape[0]
    a2 = jnp.broadcast_to(
        a.reshape(a.shape[:1] + (1,) * (len(bshape) - (a.ndim - 3)) + a.shape[1:]),
        (L,) + bshape + a.shape[-2:],
    ).reshape(L, -1, *a.shape[-2:])
    b2 = jnp.broadcast_to(
        b.reshape(b.shape[:1] + (1,) * (len(bshape) - (b.ndim - 3)) + b.shape[1:]),
        (L,) + bshape + b.shape[-2:],
    ).reshape(L, -1, *b.shape[-2:])
    out = jax.vmap(lambda x, y: _glm_core(ops, meta, x, y, mode), in_axes=1, out_axes=1)(
        a2, b2
    )
    return out.reshape((L,) + bshape + (a.shape[-2], b.shape[-1]))


def limb_matmul(meta, a, b):
    """Dispatch: Goldilocks-specialized u64 path when it applies, else the
    generic digit-plane path for any planar limb prime field."""
    if supports(meta):
        return goldilocks_matmul(meta, a, b)
    return generic_limb_matmul(meta, a, b)


def supports_any(meta) -> bool:
    return supports(meta) or supports_generic(meta)
