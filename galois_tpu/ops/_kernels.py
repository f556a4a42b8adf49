"""Device (JAX) arithmetic kernels for finite fields.

This is the XLA replacement for the reference's Numba ufunc layer
(reference: src/galois/_domains/{_ufunc,_lookup,_calculate}.py). Instead of
per-element JIT scalar kernels, every op is a whole-array jnp computation that
XLA fuses; static field parameters (p, m, irreducible poly, tables, Barrett
constants) are embedded as compile-time constants via the `FieldMeta`
descriptor.

Kernel families by storage kind:

- `PrimeOps`      GF(p), p < 2^32 — direct modular arithmetic in 32/64-bit lanes
- `BinaryExtOps`  GF(2^m), m <= 32 — carry-less multiply via shift/XOR ladders
- `OddExtOps`     GF(p^m), p odd — base-p digit vectors, convolution +
                  reduction-matrix fold (vectorized; reference does per-element
                  loops, src/galois/_domains/_calculate.py:288-324)
- `LimbPrimeOps`  GF(p), p >= 2^32 — base-2^16 limb vectors, Barrett reduction
- `LimbBinaryOps` GF(2^m), m > 32 — bit-limb carry-less multiply

`LookupOps` overlays EXP/LOG-table gathers for mul/div/pow/log on small
fields (order <= 2^20), mirroring the reference's jit-lookup mode — but add
always uses direct arithmetic (no Zech gathers).

All functions take and return arrays in the field's *internal storage*
(see FieldMeta.storage) and are pure/traceable: no data-dependent Python
control flow, so they compose with jit/vmap/shard_map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import (
    LIMB_BITS,
    STORAGE_DIGITS,
    STORAGE_INT,
    STORAGE_LIMBS,
    FieldMeta,
    int_to_limbs,
)
from ..fields._tables import build_exp_log

__all__ = ["get_ops", "FieldOps"]


def _pow_static(multiply, square, a, e: int, one):
    """a**e for a static Python-int exponent, via square-and-multiply.

    Unrolled at trace time (exponent is static), giving XLA a fixed chain.
    Handles arbitrarily large exponents — the analogue of the reference's
    63-bit-word exponent vectors (src/galois/_polys/_dense.py:338-346).
    """
    if e == 0:
        return jnp.broadcast_to(one, a.shape) if hasattr(a, "shape") else one
    result = None
    for bit in bin(e)[2:]:
        if result is not None:
            result = square(result)
        if bit == "1":
            result = a if result is None else multiply(result, a)
    return result


def _mul_u32_full(av, bv):
    """Full 64-bit product of two u32 arrays as (phi, plo) u32 words,
    built from native 16x16->32 halves with explicit carry detection."""
    LO = jnp.uint32(0xFFFF)
    a0, a1 = av & LO, av >> 16
    b0, b1 = bv & LO, bv >> 16
    ll = a0 * b0
    lh0 = a0 * b1
    lh1 = a1 * b0
    hh = a1 * b1
    t = (lh0 & LO) << 16
    plo = ll + t
    c0 = jnp.where(plo < t, jnp.uint32(1), jnp.uint32(0))
    t = (lh1 & LO) << 16
    plo2 = plo + t
    c1 = jnp.where(plo2 < t, jnp.uint32(1), jnp.uint32(0))
    phi = hh + (lh0 >> 16) + (lh1 >> 16) + c0 + c1
    return phi, plo2


def _mulmod_u32(av, bv, p: int):
    """(av*bv) mod p for 2^16 < p < 2^32, u32 arrays in, u32 out.

    Reference semantics: src/galois/_domains/_calculate.py:308-340
    (multiply_modular); the reference relies on int64 scalar arithmetic,
    this is an all-u32 redesign with no 64-bit multiply or division.
    Pipeline:
      1. 62..64-bit product from 16x16->32 halves (4 mults);
      2. fold the two high 16-bit digits with static c48 = 2^48 mod p and
         c32 = 2^32 mod p: v = d3*c48 + d2*c32 + plo < 2^17 * p + 2^32;
      3. one f32 quotient estimate q ~= v/p (v and q < 2^18 are both exact
         enough in f32 that q is within +-2 of the truth);
      4. r = v - q*p as two u32 words, then a handful of conditional
         +-p corrections bring r into [0, p).
    """
    LO = jnp.uint32(0xFFFF)

    def mul2w_const(x, C):
        # x (u32, < 2^18) times static C (< 2^32) -> (hi, lo) u32 words.
        # x splits into 16-bit halves; the two middle products are
        # accumulated separately (their sum can exceed u32 when xh > 0).
        cl, ch = C & 0xFFFF, C >> 16
        xl = x & LO
        xh = x >> 16
        t0 = xl * jnp.uint32(cl)
        t1a = xl * jnp.uint32(ch)
        t1b = xh * jnp.uint32(cl)
        t2 = xh * jnp.uint32(ch)
        mid = (t1a & LO) << 16
        lo = t0 + mid
        ca = jnp.where(lo < mid, jnp.uint32(1), jnp.uint32(0))
        mid2 = (t1b & LO) << 16
        lo2 = lo + mid2
        cb = jnp.where(lo2 < mid2, jnp.uint32(1), jnp.uint32(0))
        hi = t2 + (t1a >> 16) + (t1b >> 16) + ca + cb
        return hi, lo2

    def add2w(h1, l1, h2, l2):
        lo = l1 + l2
        carry = jnp.where(lo < l1, jnp.uint32(1), jnp.uint32(0))
        return h1 + h2 + carry, lo

    phi, plo2 = _mul_u32_full(av, bv)
    # fold digits d3 = phi>>16, d2 = phi&LO with static constants
    c32 = (1 << 32) % p
    c48 = (1 << 48) % p
    h_a, l_a = mul2w_const(phi >> 16, c48)
    h_b, l_b = mul2w_const(phi & LO, c32)
    vh, vl = add2w(h_a, l_a, h_b, l_b)
    vh, vl = add2w(vh, vl, jnp.zeros_like(vh), plo2)
    # v = vh*2^32 + vl; f32 quotient estimate (round-to-nearest, then
    # clamp the remainder with conditional +-p). vh * 2^32 is exact, so a
    # compiler that fuses the add into an FMA rounds exactly as the
    # separate add does: the +-2 slack holds either way.
    fv = vh.astype(jnp.float32) * jnp.float32(4294967296.0) + vl.astype(jnp.float32)
    q = (fv * jnp.float32(1.0 / p)).astype(jnp.uint32)  # < 2^18
    qh, ql = mul2w_const(q, p)
    # r = v - q*p (two words, may be negative by < 2p or positive < 3p)
    rl = vl - ql
    borrow = jnp.where(vl < ql, jnp.uint32(1), jnp.uint32(0))
    rh = vh - qh - borrow  # interpreted signed
    rhs = rh.astype(jnp.int32)
    # correction: while r < 0: r += p; while r >= p: r -= p.
    # |error| <= 2 quotient units, so at most 2 in each direction; a
    # third guard round costs two selects and keeps the proof slack.
    for _ in range(3):
        neg = rhs < 0
        lo_add = rl + jnp.uint32(p)
        carry = jnp.where(lo_add < rl, jnp.int32(1), jnp.int32(0))
        rl = jnp.where(neg, lo_add, rl)
        rhs = jnp.where(neg, rhs + carry, rhs)
    for _ in range(3):
        ge = (rhs > 0) | ((rhs == 0) & (rl >= jnp.uint32(p)))
        lo_sub = rl - jnp.uint32(p)
        borrow = jnp.where(rl < jnp.uint32(p), jnp.int32(1), jnp.int32(0))
        rl = jnp.where(ge, lo_sub, rl)
        rhs = jnp.where(ge, rhs - borrow, rhs)
    return rl


def _addmod_u32(x, y, p: int):
    """(x + y) mod p for x, y in [0, p), p < 2^32, with u32 wrap guard."""
    s = x + y
    wrapped = s < x
    ge = wrapped | (s >= jnp.uint32(p))
    return jnp.where(ge, s - jnp.uint32(p), s)



class FieldOps:
    """Base class: shared dynamic-exponent power and derived ops."""

    def __init__(self, meta: FieldMeta):
        self.meta = meta

    # -- required primitives (subclasses) --
    # add(a, b), subtract(a, b), negative(a), multiply(a, b),
    # reciprocal(a), zero_like(a), one_like(a), is_zero(a) -> bool mask

    def square(self, a):
        return self.multiply(a, a)

    def divide(self, a, b):
        return self.multiply(a, self.reciprocal(b))

    # -- limb-tuple protocol ------------------------------------------------
    # Composite kernels whose lax.scan/fori_loop carries are field elements
    # (pow ladders, Horner, butterfly stages) use split_limbs/join_limbs at
    # the loop boundary and the *_t methods inside. For int storage these
    # are identity passthroughs; limb fields override them so the loop
    # carry is a tuple of full arrays, one per limb — a (..., w) minor axis
    # of 4 would force a relayout at every loop iteration.

    def split_limbs(self, a):
        return a

    def join_limbs(self, t):
        return t

    def multiply_t(self, a, b):
        return self.multiply(a, b)

    def add_t(self, a, b):
        return self.add(a, b)

    def subtract_t(self, a, b):
        return self.subtract(a, b)

    def negative_t(self, a):
        return self.negative(a)

    def square_t(self, a):
        return self.square(a)

    def select_t(self, mask, x, y):
        return self._select(mask, x, y)

    def one_like_t(self, t):
        return self.one_like(t)

    def _elem_shape_t(self, t):
        if isinstance(t, tuple):
            return jnp.broadcast_shapes(*[x.shape for x in t])
        if self.meta.storage == STORAGE_INT:
            return t.shape
        if self.meta.storage_first:  # planar limbs: leading storage axis
            return t.shape[1:]
        return t.shape[:-1]

    @staticmethod
    def tmap(f, *ts):
        """Apply f leafwise over limb tuples (or directly to plain arrays)."""
        if isinstance(ts[0], tuple):
            return tuple(f(*xs) for xs in zip(*ts))
        return f(*ts)

    def broadcast_elem_t(self, t, eshape):
        """Broadcast a limb-tuple (or storage array) to element shape eshape."""
        if isinstance(t, tuple):
            return tuple(jnp.broadcast_to(L, eshape) for L in t)
        if self.meta.storage == STORAGE_INT:
            return jnp.broadcast_to(t, eshape)
        if self.meta.storage_first:
            # planar: pad element axes after the leading limb axis
            w = t.shape[0]
            pad = len(eshape) - (t.ndim - 1)
            tt = t.reshape((w,) + (1,) * pad + t.shape[1:])
            return jnp.broadcast_to(tt, (w,) + tuple(eshape))
        return jnp.broadcast_to(t, tuple(eshape) + t.shape[t.ndim - 1 :])

    def power(self, a, e):
        """a**e with a (possibly signed) integer-array exponent.

        Branch-free binary ladder with a static trip count (the bit width of
        the exponent dtype). Negative exponents invert the base first.
        0**0 = 1; 0**e = 0 for e > 0.
        """
        e = jnp.asarray(e, dtype=jnp.int64)
        neg = e < 0
        abs_e = jnp.where(neg, -e, e).astype(jnp.uint64)
        inv_a = self.reciprocal(a)
        base = self._select(neg, inv_a, a)
        return self._pow_ladder(base, abs_e)

    def power_words(self, a, words, nbits: int | None = None):
        """a**e where e = sum_i words[i] * 2^(63 i), each word a non-negative
        int64 scalar/array. Supports exponents beyond 64 bits (the analogue
        of the reference's 63-bit exponent word vectors,
        src/galois/_polys/_dense.py:338-346).

        ONE fori_loop over all bits with the current word dynamically
        indexed — a per-word ladder plus inter-word square chains compiles
        ~2 n_words separate loop bodies, which for 16-limb fields (a 255-bit
        Fermat inversion) put LLVM into the tens of minutes. All loop
        carries go through the limb-tuple protocol so limb fields keep
        full-lane layouts."""
        W = jnp.stack([jnp.asarray(w, dtype=jnp.int64) for w in words]).astype(jnp.uint64)
        total = 63 * len(words) if nbits is None else nbits
        cur = self.split_limbs(a)
        # Words may be per-element exponent arrays: broadcast the carry to
        # the joint element shape up front so the loop carry is shape-stable.
        out_shape = jnp.broadcast_shapes(self._elem_shape_t(cur), W.shape[1:])
        cur = self.broadcast_elem_t(cur, out_shape)
        W = W.reshape(W.shape[:1] + (1,) * (len(out_shape) - (W.ndim - 1)) + W.shape[1:])
        W = jnp.broadcast_to(W, W.shape[:1] + tuple(out_shape))

        def body(i, carry):
            result, b = carry
            w = W[i // 63]
            bit = ((w >> (i % 63).astype(jnp.uint64)) & 1).astype(bool)
            result = self.select_t(bit, self.multiply_t(result, b), result)
            return (result, self.square_t(b))

        one = self.one_like_t(cur)
        result, _ = jax.lax.fori_loop(0, total, body, (one, cur))
        return self.join_limbs(result)

    def power_static(self, a, e: int):
        """a**e for a static Python int exponent (may exceed 64 bits)."""
        if e < 0:
            return self.power_static(self.reciprocal(a), -e)
        if e == 0:
            return self.one_like(a)
        return _pow_static(self.multiply, self.square, a, e, self.one_like(a))

    def _pow_int_compact(self, a, e: int):
        """a**e via the dynamic ladder with a constant exponent.

        Same result as power_static but with a fori_loop body compiled ONCE —
        used when one multiply is itself a large graph (limb/digit fields),
        where a fully unrolled Fermat chain would bloat compile times."""
        if e < 0:
            return self._pow_int_compact(self.reciprocal(a), -e)
        if e == 0:
            return self.one_like(a)
        words = []
        rem = e
        while rem:
            words.append(jnp.asarray(rem & ((1 << 63) - 1), dtype=jnp.int64))
            rem >>= 63
        return self.power_words(a, words, nbits=e.bit_length())

    def _pow_ladder(self, base, abs_e, nbits: int = 64):
        return self.join_limbs(self._pow_ladder_t(self.split_limbs(base), abs_e, nbits))

    def _pow_ladder_t(self, base_t, abs_e, nbits: int = 64):
        """Binary ladder over a limb-tuple base (identity tuple for int
        storage). The loop carry never materializes the (..., w) minor-axis
        layout, which costs a lane relayout per iteration on limb fields.
        Base and exponent broadcast both ways so the carry is shape-stable."""
        abs_e = jnp.asarray(abs_e)
        out_shape = jnp.broadcast_shapes(self._elem_shape_t(base_t), abs_e.shape)
        base_t = self.broadcast_elem_t(base_t, out_shape)
        abs_e = jnp.broadcast_to(abs_e, out_shape)

        def body(i, carry):
            result, b, e = carry
            bit = (e & 1).astype(bool)
            result = self.select_t(bit, self.multiply_t(result, b), result)
            return (result, self.square_t(b), e >> 1)

        one = self.one_like_t(base_t)
        result, _, _ = jax.lax.fori_loop(0, nbits, body, (one, base_t, abs_e))
        return result

    def _select(self, mask, x, y):
        """jnp.where with the mask aligned to the storage layout: expanded
        over the trailing digit axis; planar limb arrays need no expansion
        (the element-shaped mask right-aligns under the leading limb axis)."""
        if self.meta.storage == STORAGE_DIGITS:
            mask = jnp.asarray(mask)[..., None]
        return jnp.where(mask, x, y)

    def one_like(self, a):
        raise NotImplementedError

    def zero_like(self, a):
        raise NotImplementedError

    def is_zero(self, a):
        raise NotImplementedError

    def sqrt(self, a):
        """Square root; for non-squares the result is unspecified (callers
        validate with is_square first, as the reference does)."""
        q = self.meta.order
        p = self.meta.characteristic
        if p == 2:
            # a^(2^(m-1)): squaring is the inverse of sqrt's Frobenius
            return self.power_static(a, q // 2)
        if q % 4 == 3:
            root = self.power_static(a, (q + 1) // 4)
        elif q % 8 == 5:
            # Atkin: t = (2a)^((q-5)/8), i = 2a t^2, root = a t (i - 1)
            a2 = self.add(a, a)
            t = self.power_static(a2, (q - 5) // 8)
            i_val = self.multiply(a2, self.square(t))
            root = self.multiply(
                self.multiply(a, t),
                self.subtract(i_val, self.one_like(a)),
            )
        else:
            root = self._tonelli_shanks(a)
        # Return the "smaller" root for reproducibility (reference returns the
        # root whose integer repr is <= that of its negation).
        neg_root = self.negative(root)
        return self._select(self._repr_le(root, neg_root), root, neg_root)

    def _repr_le(self, a, b):
        """Mask: integer repr of a <= integer repr of b (for root canonicalization)."""
        raise NotImplementedError

    def _tonelli_shanks(self, a):
        q = self.meta.order
        Q, S = q - 1, 0
        while Q % 2 == 0:
            Q //= 2
            S += 1
        # Find a non-square z host-side (exact Python-int arithmetic).
        from ..fields._hostfield import get_host_field

        z_int = get_host_field(self.meta).find_non_square()
        # Everything below runs on limb tuples with fori_loop trip counts —
        # S can be large (Goldilocks has S=32) and the loops nest O(S^2), so
        # unrolling them is a compile-time cliff (see _pow_int_compact).
        m_cur = jnp.full(jnp.asarray(self.is_zero(a)).shape, S, dtype=jnp.int32)
        eshape = m_cur.shape
        t = self.split_limbs(self.power_static(a, Q))
        r = self.split_limbs(self.power_static(a, (Q + 1) // 2))
        c0 = self.split_limbs(self.power_static(self.from_int_scalar(z_int), Q))
        c = self.broadcast_elem_t(c0, eshape)
        one = self.one_like_t(t)

        def round_body(_, carry):
            t, r, c, m_cur = carry

            # least i with t^(2^i) == 1 by scanning squarings
            def find_body(i, fc):
                tt, i_found, done = fc
                tt = self.square_t(tt)
                hit = (~done) & jnp.asarray(self.eq_t(tt, one))
                i_found = jnp.where(hit, i, i_found)
                return (tt, i_found, done | hit)

            done0 = jnp.asarray(self.eq_t(t, one))
            _, i_found, _ = jax.lax.fori_loop(
                1, S + 1, find_body, (t, jnp.zeros_like(m_cur), done0)
            )
            # b = c^(2^shift) with shift = m-i-1, via masked repeated squaring
            shift = jnp.maximum(m_cur - i_found - 1, 0)
            b = jax.lax.fori_loop(
                0, S, lambda j, b: self.select_t(j < shift, self.square_t(b), b), c
            )
            finished = i_found == 0
            r = self.select_t(finished, r, self.multiply_t(r, b))
            c_new = self.square_t(b)
            t = self.select_t(finished, t, self.multiply_t(t, c_new))
            c = self.select_t(finished, c, c_new)
            m_cur = jnp.where(finished, m_cur, i_found)
            return (t, r, c, m_cur)

        t, r, c, m_cur = jax.lax.fori_loop(0, S, round_body, (t, r, c, m_cur))
        return self.join_limbs(r)

    def _eq(self, a, b):
        if self.meta.storage == STORAGE_INT:
            return a == b
        if self.meta.storage_first:
            return jnp.all(a == b, axis=0)
        return jnp.all(a == b, axis=-1)

    def eq_t(self, a, b):
        return self._eq(a, b)

    def from_int_scalar(self, x: int):
        """Static Python int -> internal-storage 0-d constant."""
        meta = self.meta
        if meta.storage == STORAGE_INT:
            return jnp.asarray(x, dtype=meta.internal_dtype)
        if meta.storage == STORAGE_DIGITS:
            return jnp.asarray(meta.int_to_digits(x), dtype=meta.internal_dtype)
        return jnp.asarray(int_to_limbs(x, meta.storage_width), dtype=meta.internal_dtype)


# ======================================================================
# GF(p), p < 2^32, int storage
# ======================================================================

class PrimeOps(FieldOps):
    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        p = meta.characteristic
        self.p = p
        self.dt = jnp.dtype(meta.internal_dtype)
        # Mersenne primes get an all-u32 multiply (2^e === 1 folds) with no
        # u64 product. e == 31 splits the product into 16-bit halves;
        # e <= 16 fits the whole u32 product directly.
        e = p.bit_length()
        self._mersenne_e = e if (p == (1 << e) - 1 and (e == 31 or p <= 2**16)) else None

    def _w(self, a):
        return a.astype(jnp.uint32)

    def add(self, a, b):
        # wrap-guarded u32 modular add (a + b can exceed 2^32 for p > 2^31)
        return _addmod_u32(self._w(a), self._w(b), self.p).astype(self.dt)

    def negative(self, a):
        p = self.p
        aw = self._w(a)
        return jnp.where(aw == 0, aw, jnp.uint32(p) - aw).astype(self.dt)

    def subtract(self, a, b):
        # a - b + p computed mod 2^32: the true value is in [0, p) < 2^32,
        # so the wrapped low word IS the result.
        aw, bw = self._w(a), self._w(b)
        d = aw - bw
        return jnp.where(aw < bw, d + jnp.uint32(self.p), d).astype(self.dt)

    def multiply(self, a, b):
        e = self._mersenne_e
        if e == 31:
            return self._mul_mersenne31(a, b)
        if e is not None:
            return self._mul_mersenne_small(a, b, e)
        if self.p > 2**16:
            return self._mul_barrett_u32(a, b)
        return ((self._w(a) * self._w(b)) % self.p).astype(self.dt)

    def _mul_barrett_u32(self, a, b):
        return _mulmod_u32(a.astype(jnp.uint32), b.astype(jnp.uint32), self.p).astype(self.dt)

    def _mul_mersenne31(self, a, b):
        """(a*b) mod 2^31-1 in pure u32: 62-bit product from 16-bit halves
        (P = phi*2^32 + plo), then 2^31 === 1 folds (2^32 === 2)."""
        P = jnp.uint32(self.p)
        LO = jnp.uint32(0xFFFF)

        def fold(x):
            return (x & P) + (x >> 31)

        av = a.astype(jnp.uint32)
        bv = b.astype(jnp.uint32)
        a0 = av & LO
        a1 = av >> 16
        b0 = bv & LO
        b1 = bv >> 16
        ll = a0 * b0
        lh = a0 * b1 + a1 * b0  # < 2^32, no overflow
        hh = a1 * b1
        t = (lh & LO) << 16
        plo = t + ll
        carry = jnp.where(plo < t, jnp.uint32(1), jnp.uint32(0))
        phi = hh + (lh >> 16) + carry
        r = fold(fold(fold(plo)) + fold(fold(phi << 1)))
        r = fold(r)
        return jnp.where(r == P, jnp.uint32(0), r).astype(self.dt)

    def _mul_mersenne_small(self, a, b, e: int):
        """(a*b) mod 2^e-1 for e <= 16: the u32 product is exact; fold until
        the static bound drops to p, then one conditional subtract."""
        p = self.p
        P = jnp.uint32(p)
        r = a.astype(jnp.uint32) * b.astype(jnp.uint32)
        # fold maps [0, B] into [0, p + (B >> e)]; once B <= 2^e one more
        # fold lands in [0, p] (x = 2^e folds to 1).
        bound = (p - 1) * (p - 1)
        while bound > p + 1:
            r = (r & P) + (r >> e)
            bound = p + (bound >> e)
        r = (r & P) + (r >> e)
        return jnp.where(r == P, jnp.uint32(0), r).astype(self.dt)

    def reciprocal(self, a):
        return self.power_static(a, self.p - 2)

    def one_like(self, a):
        return jnp.ones_like(a)

    def zero_like(self, a):
        return jnp.zeros_like(a)

    def is_zero(self, a):
        return a == 0

    def _repr_le(self, a, b):
        return a <= b


class GF2Ops(PrimeOps):
    """GF(2): pure bitwise ops (reference: src/galois/_fields/_gf2.py:25-101)."""

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        return a & b

    def reciprocal(self, a):
        return a

    def divide(self, a, b):
        return a & b

    def power(self, a, e):
        e = jnp.asarray(e)
        return jnp.where(e == 0, jnp.ones_like(a), a)

    def power_static(self, a, e: int):
        return jnp.ones_like(a) if e == 0 else a

    def sqrt(self, a):
        return a


# ======================================================================
# GF(2^m), m <= 32, int storage
# ======================================================================

class BinaryExtOps(FieldOps):
    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.m = meta.degree
        self.f = meta.irreducible_poly_int
        self.dt = jnp.dtype(meta.internal_dtype)
        self.two_words = 2 * self.m - 1 > 32  # m in 17..32: (lo, hi) u32 pair
        # Reduction constant R = f - x^m: x^m ≡ R (mod f). Folding the
        # overflow bits down is a constant carry-less multiply by R —
        # popcount(R) shift-xors per round instead of a per-bit select
        # ladder, and never an integer multiply.
        R = self.f ^ (1 << self.m)
        self._r_bits = [k for k in range(R.bit_length()) if (R >> k) & 1]
        self._deg_r = max(self._r_bits) if self._r_bits else 0

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def _clmul(self, a, b):
        """Carry-less product, 2m-1 <= 31 bits, in one u32 word (m <= 16).
        Partial products are gated by an arithmetic all-ones mask (0 - bit):
        pure shift/and/xor, no integer multiply."""
        aw = a.astype(jnp.uint32)
        bw = b.astype(jnp.uint32)
        acc = jnp.zeros_like(aw)
        one = jnp.uint32(1)
        zero = jnp.uint32(0)
        for i in range(self.m):
            mask = zero - ((bw >> i) & one)
            acc = acc ^ ((aw << i) & mask)
        return acc

    def _reduce(self, c):
        """Reduce a <=31-bit carry-less product mod f via constant folds."""
        m = self.m
        lo_mask = jnp.uint32((1 << m) - 1)
        width = 2 * m - 1
        while width > m:
            o = c >> m
            c = c & lo_mask
            for k in self._r_bits:
                c = c ^ (o << k)
            width = max(m, width - m + self._deg_r)
        return c.astype(self.dt)

    def _clmul2(self, a, b):
        """Carry-less product for m in 17..32 as a (lo, hi) u32 pair
        (reference scalar form: src/galois/_domains/_calculate.py:288-324) —
        all in u32 words, with no 64-bit integer ops."""
        a32 = a.astype(jnp.uint32)
        b32 = b.astype(jnp.uint32)
        lo = jnp.zeros_like(a32)
        hi = jnp.zeros_like(a32)
        one = jnp.uint32(1)
        zero = jnp.uint32(0)
        for i in range(self.m):
            mask = zero - ((b32 >> i) & one)
            lo = lo ^ ((a32 << i) & mask)
            if i:
                hi = hi ^ ((a32 >> (32 - i)) & mask)
        return lo, hi

    def _reduce2(self, lo, hi):
        """Reduce a (lo, hi) two-word carry-less product mod f (17<=m<=32).

        Every overflow poly o = c >> m fits one u32 word (at most
        width - m <= 30 bits), so each fold is: extract o, keep the low m
        bits, xor in o*R word-wise."""
        m = self.m
        lo_mask = jnp.uint32((1 << m) - 1) if m < 32 else jnp.uint32(0xFFFFFFFF)
        width = 2 * m - 1
        while width > m:
            if m == 32:
                o = hi
            else:
                o = (lo >> m) | (hi << (32 - m))
            lo = lo & lo_mask
            hi = jnp.zeros_like(hi)
            for k in self._r_bits:
                lo = lo ^ (o << k)
                if k:
                    hi = hi ^ (o >> (32 - k))
            width = max(m, width - m + self._deg_r)
        return lo.astype(self.dt)

    # Reference semantics: src/galois/_domains/_calculate.py:288-324.
    def multiply(self, a, b):
        if self.two_words:
            return self._reduce2(*self._clmul2(a, b))
        return self._reduce(self._clmul(a, b))

    def square(self, a):
        # Squaring is bit-spreading (a_i -> bit 2i) then reduction — linear in m.
        aw = a.astype(jnp.uint32)
        one = jnp.uint32(1)
        if self.two_words:
            lo = jnp.zeros_like(aw)
            hi = jnp.zeros_like(aw)
            for i in range(self.m):
                bit = (aw >> i) & one
                if 2 * i < 32:
                    lo = lo ^ (bit << (2 * i))
                else:
                    hi = hi ^ (bit << (2 * i - 32))
            return self._reduce2(lo, hi)
        acc = jnp.zeros_like(aw)
        for i in range(self.m):
            acc = acc ^ (((aw >> i) & one) << (2 * i))
        return self._reduce(acc)

    def power_static(self, a, e: int):
        # Large static exponents use the compact ladder (small XLA graph);
        # small ones stay unrolled (fewer runtime multiplies).
        if abs(e).bit_length() > 16:
            return self._pow_int_compact(a, e)
        return super().power_static(a, e)

    def reciprocal(self, a):
        # Itoh-Tsujii: a^(2^m - 2) = (a^(2^(m-1) - 1))^2 with an addition
        # chain on m-1 (reference: src/galois/_domains/_calculate.py:447-489).
        m = self.m
        t = a  # a^(2^1 - 1)
        k = 1
        for bit in bin(m - 1)[3:]:
            tk = t
            for _ in range(k):
                tk = self.square(tk)
            t = self.multiply(tk, t)
            k *= 2
            if bit == "1":
                t2 = self.square(t)
                t = self.multiply(t2, a)
                k += 1
        return self.square(t)

    def one_like(self, a):
        return jnp.ones_like(a)

    def zero_like(self, a):
        return jnp.zeros_like(a)

    def is_zero(self, a):
        return a == 0

    def _repr_le(self, a, b):
        return a <= b

    def sqrt(self, a):
        # m-1 squarings: sqrt(a) = a^(2^(m-1))
        r = a
        for _ in range(self.m - 1):
            r = self.square(r)
        return r


# ======================================================================
# GF(p^m), p odd — digit vectors
# ======================================================================

class OddExtOps(FieldOps):
    """Digit-vector arithmetic. Storage is either int (order <= 2^31, decomposed
    on the fly) or (..., m) digit vectors."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic
        self.m = meta.degree
        self.dt = jnp.dtype(meta.internal_dtype)
        self.int_storage = meta.storage == STORAGE_INT
        # NumPy, not jnp: ops objects are cached across traces, so any jnp
        # constant created here would leak tracers when first built under jit.
        self.R = np.asarray(meta.reduction_matrix)  # (m-1, m) int64

    # -- digit conversion (device) --
    def _digits(self, a):
        if not self.int_storage:
            return a
        p, m = self.p, self.m
        x = a.astype(jnp.uint32)
        digs = []
        for _ in range(m):
            digs.append(x % p)
            x = x // p
        return jnp.stack(digs, axis=-1)

    def _undigits(self, d):
        if not self.int_storage:
            return d.astype(self.dt)
        p, m = self.p, self.m
        # int storage means order <= 2^31: every partial digit*p^i and the
        # running sum are < order, so u32 is exact (no emulated u64).
        weights = jnp.asarray([p**i for i in range(m)], dtype=jnp.uint32)
        return jnp.sum(d.astype(jnp.uint32) * weights, axis=-1).astype(self.dt)

    def add(self, a, b):
        A, B = self._digits(a), self._digits(b)
        # wrap-guarded: digit sums exceed 2^32 when p > 2^31
        return self._undigits(_addmod_u32(A.astype(jnp.uint32), B.astype(jnp.uint32), self.p))

    def negative(self, a):
        A = self._digits(a).astype(jnp.uint32)
        n = jnp.where(A == 0, A, self.p - A)
        return self._undigits(n)

    def subtract(self, a, b):
        # a - b + p computed mod 2^32: the true digit is in [0, p) < 2^32,
        # so the wrapped low word IS the result (A + (p - B) overflows u32
        # for p > 2^31).
        A = self._digits(a).astype(jnp.uint32)
        B = self._digits(b).astype(jnp.uint32)
        d = A - B
        return self._undigits(jnp.where(A < B, d + jnp.uint32(self.p), d))

    def _mul_digits(self, A, B):
        # Elementwise shift-accumulate convolution + reduction-matrix fold.
        # Elementwise (no dot_general), all-u32 in all regimes:
        #  - m*(p-1)^2 < 2^32: plain u32 accumulation, one % p at the end;
        #  - p <= 2^16: per-partial u32 % p, digit sums stay < m * 2^16;
        #  - p > 2^16: per-partial u32 Barrett mulmod (no u64 emulation),
        #    accumulated with wrap-guarded modular adds.
        p, m = self.p, self.m
        shape = jnp.broadcast_shapes(A.shape[:-1], B.shape[:-1])
        if m * (p - 1) ** 2 < 2**32:
            Aw = A.astype(jnp.uint32)
            Bw = B.astype(jnp.uint32)
            full = jnp.zeros(shape + (2 * m - 1,), dtype=jnp.uint32)
            for i in range(m):
                full = full.at[..., i : i + m].add(Aw[..., i : i + 1] * Bw)
            full = full % p
            low, high = full[..., :m], full[..., m:]
            red = jnp.zeros(shape + (m,), dtype=jnp.uint32)
            for k in range(m - 1):
                row = jnp.asarray(self.R[k], dtype=jnp.uint32)
                red = (red + high[..., k : k + 1] * row) % p
            return ((low + red) % p).astype(jnp.uint32)
        Aw = jnp.broadcast_to(A, shape + (m,)).astype(jnp.uint32)
        Bw = jnp.broadcast_to(B, shape + (m,)).astype(jnp.uint32)

        def mulmod(x, y):
            if p <= 2**16:
                return (x * y) % p  # product < 2^32, exact in u32
            return _mulmod_u32(x, y, p)

        full = jnp.zeros(shape + (2 * m - 1,), dtype=jnp.uint32)
        for i in range(m):
            part = mulmod(Aw[..., i : i + 1], Bw)  # each entry in [0, p)
            full = full.at[..., i : i + m].set(_addmod_u32(full[..., i : i + m], part, p))
        low, high = full[..., :m], full[..., m:]
        red = jnp.zeros(shape + (m,), dtype=jnp.uint32)
        for k in range(m - 1):
            row = jnp.asarray(self.R[k], dtype=jnp.uint32)
            red = _addmod_u32(red, mulmod(high[..., k : k + 1], row), p)
        return _addmod_u32(low, red, p).astype(jnp.uint32)

    def multiply(self, a, b):
        return self._undigits(self._mul_digits(self._digits(a), self._digits(b)))

    def power_static(self, a, e: int):
        # Large static exponents use the compact ladder (small XLA graph);
        # small ones stay unrolled (fewer runtime multiplies).
        if abs(e).bit_length() > 16:
            return self._pow_int_compact(a, e)
        return super().power_static(a, e)

    def reciprocal(self, a):
        return self._pow_int_compact(a, self.meta.order - 2)

    def one_like(self, a):
        if self.int_storage:
            return jnp.ones_like(a)
        one = jnp.zeros_like(a)
        return one.at[..., 0].set(1)

    def zero_like(self, a):
        return jnp.zeros_like(a)

    def is_zero(self, a):
        if self.int_storage:
            return a == 0
        return jnp.all(a == 0, axis=-1)

    def _repr_le(self, a, b):
        if self.int_storage:
            return a <= b
        # Lexicographic compare, most-significant digit first
        le = jnp.ones(jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=bool)
        decided = jnp.zeros_like(le)
        for i in range(self.m - 1, -1, -1):
            ai, bi = a[..., i], b[..., i]
            le = jnp.where(decided, le, jnp.where(ai != bi, ai < bi, le))
            decided = jnp.logical_or(decided, ai != bi)
        return le


# ======================================================================
# Limb arithmetic (base 2^16) — huge prime fields
# ======================================================================

class _PlanarTupleMixin:
    """Shared limb-tuple protocol for PLANAR (L, *elem_shape) limb storage.

    Every limb plane is a full contiguous array; all arithmetic runs on
    tuples of u32 planes, with split/join at
    the storage boundary reduced to free major-axis slices / one stack.
    Subclasses must set `self.L` (storage limb count) and `self.dt`
    (storage dtype)."""

    def split_limbs(self, a):
        return tuple(a[k].astype(jnp.uint32) for k in range(self.L))

    def join_limbs(self, t):
        shape = jnp.broadcast_shapes(*[x.shape for x in t])
        return jnp.stack([jnp.broadcast_to(x, shape) for x in t], axis=0).astype(self.dt)

    def one_like_t(self, t):
        z = jnp.zeros_like(t[0])
        return (jnp.ones_like(t[0]),) + (z,) * (len(t) - 1)

    def select_t(self, mask, x, y):
        mask = jnp.asarray(mask)
        return tuple(jnp.where(mask, xk, yk) for xk, yk in zip(x, y))

    def eq_t(self, a, b):
        r = a[0] == b[0]
        for ak, bk in zip(a[1:], b[1:]):
            r = r & (ak == bk)
        return r

    def is_zero_t(self, a):
        r = a[0] == 0
        for ak in a[1:]:
            r = r & (ak == 0)
        return r

    def _bcast2_t(self, a, b):
        shape = jnp.broadcast_shapes(
            jnp.broadcast_shapes(*[x.shape for x in a]),
            jnp.broadcast_shapes(*[x.shape for x in b]),
        )
        d = [jnp.broadcast_to(x, shape).astype(jnp.uint32) for x in a]
        e = [jnp.broadcast_to(x, shape).astype(jnp.uint32) for x in b]
        return d, e, shape


def unroll_one_shot(L: int, n_elems: int) -> bool:
    """Form of a one-shot L-limb multiply (outside any scan body: a
    storage-level multiply, the NTT twiddle, the limb-matmul combine) over
    ``n_elems`` elements per limb plane.

    The fold form (LimbPrimeOps._fold_diagonals) writes (L, L, n) and
    (2L^2, n) u32 intermediates to device memory; the unrolled form is one
    fused pass, but a ~4L^2-op graph that compiles slower (minutes of LLVM
    on the CPU). Measured on an H100 80GB HBM3 at 700 W, BLS12-381 (L = 16):
    an elementwise multiply of 2^22 elements takes 3.7 ms unrolled against
    40.2 ms folded (compile 10.6 s against 6.8 s), one 2048^3 limb-matmul
    side 37.2 ms against 66.1 ms, and 2^16 elements 0.18 ms against
    0.92 ms (compile 12.4 s against 6.4 s). So the unrolled form is taken
    once the fold's outer product would reach 1 GiB (2^20 elements at
    L = 16), where it also keeps a 2^24-element multiply in memory; small
    arrays keep the fold, whose compile time dominates there."""
    return L > 4 and L * L * n_elems >= 2**28


class LimbPrimeOps(_PlanarTupleMixin, FieldOps):
    """GF(p) for p >= 2^32: little-endian base-2^16 limb vectors, Barrett
    reduction with host-precomputed mu. All intermediates in u32 lanes —
    limb products split into 16-bit lo/hi columns (column sums stay < 2^22),
    so no emulated 64-bit integer op appears anywhere. Planar limb-tuple
    protocol from _PlanarTupleMixin."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.L = meta.storage_width
        self.p_int = meta.characteristic
        # NumPy (not jnp): cached across traces — see OddExtOps note.
        self.p_limbs = np.asarray(int_to_limbs(self.p_int, self.L))  # int64
        self.mu_limbs = np.asarray(
            int_to_limbs((1 << (2 * LIMB_BITS * self.L)) // self.p_int, self.L + 1)
        )
        self.dt = jnp.dtype(meta.internal_dtype)
        self.MASK = (1 << LIMB_BITS) - 1

    def _carry_norm_t(self, cols):
        """Propagate carries so all planes are < 2^16. cols: list of u32
        planes holding sums of 16-bit quantities (< 2^22)."""
        out = []
        carry = jnp.zeros(jnp.broadcast_shapes(*[c.shape for c in cols]), jnp.uint32)
        for c in cols:
            v = c + carry
            out.append(v & self.MASK)
            carry = v >> LIMB_BITS
        return out

    def _mul_full_t(self, a, b, unroll: bool = False):
        """Schoolbook product -> 2L carry-normalized limb planes (u32).

        Small L keeps the fused elementwise double loop (O(L^2) tiny ops,
        XLA fuses them). Large L folds the anti-diagonals with one exact
        int8 matmul instead: the unrolled loop is ~4 L^2 HLO ops PER
        MULTIPLY, and a 16-limb Fermat pow ladder (reciprocal of a 255-bit
        prime) made LLVM spin for tens of minutes compiling the scan body.

        ``unroll=True`` opts BACK into the fused elementwise loop for
        one-shot call sites outside any scan (NTT twiddle, matmul combine):
        the fold writes (2L^2, N) u32 intermediates to device memory, while
        a straight-line 4L^2-op graph compiles fine when it is not inside a
        loop body (see `unroll_one_shot`). Column sums stay
        < 2^22 for L <= 32, so the unrolled path is exact for every
        supported width."""
        L = self.L
        d, e, shape = self._bcast2_t(a, b)
        if L <= 4 or unroll:
            zero = jnp.zeros(shape, jnp.uint32)
            cols = [zero] * (2 * L)
            for i in range(L):
                for j in range(L):
                    prod = d[i] * e[j]  # 16x16 -> 32, native
                    k = i + j
                    cols[k] = cols[k] + (prod & self.MASK)
                    cols[k + 1] = cols[k + 1] + (prod >> LIMB_BITS)
                    # column sums <= 2L * (2^16 - 1) < 2^22 for L <= 32
            return self._carry_norm_t(cols)
        D = jnp.stack(d)  # (L, *shape)
        E = jnp.stack(e)
        P = D[:, None] * E[None, :]  # (L, L, *shape) u32, < 2^32
        cols = self._fold_diagonals(P, shape, self._mul_full_fold)
        return self._carry_norm_t(cols)

    @functools.cached_property
    def _mul_full_fold(self):
        """(2L, 2L^2) 0/1 int8 host matrix folding [lo planes; hi planes]
        of the (L, L) outer product onto anti-diagonal columns k = i + j
        (lo) and k = i + j + 1 (hi)."""
        L = self.L
        M = np.zeros((2 * L, 2 * L * L), dtype=np.int8)
        for i in range(L):
            for j in range(L):
                M[i + j, i * L + j] = 1
                M[i + j + 1, L * L + i * L + j] = 1
        return M

    def _fold_diagonals(self, P, shape, M: np.ndarray):
        """Sum u32 products (< 2^32) over anti-diagonals with exact 7-bit
        int8 -> int32 matmuls (same plane trick as ops/_limb_matmul.py).
        P: (T, *shape) after splitting lo/hi; M: (ncols, 2T) host 0/1."""
        T = P.shape[0] * P.shape[1] if P.ndim - len(shape) == 2 else P.shape[0]
        flat = P.reshape(T, -1)
        G = jnp.concatenate([flat & self.MASK, flat >> LIMB_BITS], axis=0)  # (2T, N) < 2^16
        from ._linalg import int8_matmul

        Mj = jnp.asarray(M)
        acc = None
        for pl in range(3):  # 16 bits -> three 7-bit planes
            g = ((G >> (7 * pl)) & 127).astype(jnp.int8)
            c = int8_matmul(Mj, g).astype(jnp.uint32)
            acc = c << (7 * pl) if acc is None else acc + (c << (7 * pl))
        # row sums <= 2L * (2^16 - 1) < 2^22: carry_norm's invariant holds
        return [acc[k].reshape(shape) for k in range(M.shape[0])]

    def _mul_const_t(self, a, const_limbs: np.ndarray, unroll: bool = False):
        """a (limb planes) times a static limb constant -> carry-normalized.
        ``unroll`` as in _mul_full_t (one-shot sites only, never scan
        bodies)."""
        K = len(const_limbs)
        L = len(a)
        aw = [x.astype(jnp.uint32) for x in a]
        shape = jnp.broadcast_shapes(*[x.shape for x in aw])
        if L <= 4 or unroll:
            zero = jnp.zeros(shape, jnp.uint32)
            cols = [zero] * (L + K)
            for j, cj in enumerate(const_limbs):
                cj = int(cj)
                if cj:
                    for i in range(L):
                        prod = aw[i] * jnp.uint32(cj)
                        cols[i + j] = cols[i + j] + (prod & self.MASK)
                        cols[i + j + 1] = cols[i + j + 1] + (prod >> LIMB_BITS)
            return self._carry_norm_t(cols)
        A = jnp.stack([jnp.broadcast_to(x, shape) for x in aw])  # (L, *shape)
        C = jnp.asarray(np.asarray(const_limbs, dtype=np.uint32))
        P = A[:, None] * C[None, :].reshape((1, K) + (1,) * len(shape))  # (L, K, *shape)
        M = np.zeros((L + K, 2 * L * K), dtype=np.int8)
        for i in range(L):
            for j in range(K):
                M[i + j, i * K + j] = 1
                M[i + j + 1, L * K + i * K + j] = 1
        cols = self._fold_diagonals(P, shape, M)
        return self._carry_norm_t(cols)

    def _sub_limbs_t(self, r, sub, K: int):
        """r - sub with borrow chains over K normalized u32 planes; sub may
        be a list of static ints or planes. Returns (diff planes, borrow)."""
        borrow = jnp.zeros(jnp.broadcast_shapes(*[x.shape for x in r]), jnp.uint32)
        diff = []
        for k in range(K):
            sk = sub[k]
            t = (jnp.uint32(int(sk)) if isinstance(sk, (int, np.integer)) else sk) + borrow
            rk = r[k]
            b_out = rk < t
            diff.append((rk - t) & self.MASK)
            borrow = b_out.astype(jnp.uint32)
        return diff, borrow

    def _sub_if_ge_t(self, r, modulus_limbs):
        """r - modulus if r >= modulus else r, over K normalized planes;
        modulus zero-extended to K (host ints, static)."""
        K = len(r)
        mod = [0] * K
        for k, v in enumerate(np.asarray(modulus_limbs)):
            mod[k] = int(v)
        diff, borrow = self._sub_limbs_t(r, mod, K)
        ge = borrow == 0
        return [jnp.where(ge, df, rr) for df, rr in zip(diff, r)]

    def _barrett_t(self, x, unroll: bool = False):
        """x (2L normalized planes) mod p -> L planes. HAC Alg 14.42, b=2^16."""
        L = self.L
        # q1 = floor(x / b^(L-1)) : limbs L-1 .. 2L-1 (L+1 planes)
        q1 = x[L - 1 :]
        # q2 = q1 * mu (mu has L+1 limbs) -> up to 2L+2 planes
        q2 = self._mul_const_t(q1, self.mu_limbs, unroll=unroll)
        # q3 = floor(q2 / b^(L+1))
        q3 = q2[L + 1 :]
        # r1 = x mod b^(L+1)
        r1 = x[: L + 1]
        # r2 = (q3 * p) mod b^(L+1)
        q3p = self._mul_const_t(q3, np.asarray(self.p_limbs), unroll=unroll)
        r2 = q3p[: L + 1]
        # r = r1 - r2 (mod b^(L+1)); result in [0, 3p)
        r, _ = self._sub_limbs_t(r1, r2, L + 1)
        # at most 2 conditional subtracts
        r = self._sub_if_ge_t(r, self.p_limbs)
        r = self._sub_if_ge_t(r, self.p_limbs)
        return tuple(r[: self.L])

    def multiply_t(self, a, b, unroll: bool = False):
        return self._barrett_t(self._mul_full_t(a, b, unroll=unroll), unroll=unroll)

    def square_t(self, a):
        return self.multiply_t(a, a)

    def add_t(self, a, b):
        d, e, shape = self._bcast2_t(a, b)
        s = self._carry_norm_t([dk + ek for dk, ek in zip(d, e)] + [jnp.zeros(shape, jnp.uint32)])
        s = self._sub_if_ge_t(s, self.p_limbs)
        return tuple(s[: self.L])

    def negative_t(self, a):
        # p - a, with 0 -> 0
        aw = [x.astype(jnp.uint32) for x in a]
        shape = jnp.broadcast_shapes(*[x.shape for x in aw])
        borrow = jnp.zeros(shape, jnp.uint32)
        out = []
        zero_mask = self.is_zero_t(a)
        for k in range(self.L):
            t = aw[k] + borrow
            pk = jnp.uint32(int(self.p_limbs[k]))
            b_out = pk < t
            out.append((pk - t) & self.MASK)
            borrow = b_out.astype(jnp.uint32)
        return tuple(
            jnp.where(zero_mask, jnp.broadcast_to(ak, shape), nk) for ak, nk in zip(aw, out)
        )

    def subtract_t(self, a, b):
        return self.add_t(a, self.negative_t(b))

    # -- planar-storage entry points: split, compute, join. XLA cancels
    # adjacent join/split pairs between chained ops.

    def multiply(self, a, b):
        # A storage-level multiply is a one-shot site (scan bodies carry
        # limb tuples through multiply_t), so its form follows the policy.
        n = int(np.prod(jnp.broadcast_shapes(a.shape[1:], b.shape[1:]), dtype=np.int64))
        unroll = unroll_one_shot(self.L, n)
        return self.join_limbs(
            self.multiply_t(self.split_limbs(a), self.split_limbs(b), unroll=unroll)
        )

    def add(self, a, b):
        return self.join_limbs(self.add_t(self.split_limbs(a), self.split_limbs(b)))

    def subtract(self, a, b):
        return self.join_limbs(self.subtract_t(self.split_limbs(a), self.split_limbs(b)))

    def negative(self, a):
        return self.join_limbs(self.negative_t(self.split_limbs(a)))

    def square(self, a):
        return self.join_limbs(self.square_t(self.split_limbs(a)))

    def power_static(self, a, e: int):
        # Large static exponents use the compact ladder (small XLA graph);
        # small ones stay unrolled (fewer runtime multiplies).
        if abs(e).bit_length() > 16:
            return self._pow_int_compact(a, e)
        return super().power_static(a, e)

    def reciprocal(self, a):
        return self._pow_int_compact(a, self.p_int - 2)

    def one_like(self, a):
        one = jnp.zeros_like(a)
        return one.at[0].set(1)

    def zero_like(self, a):
        return jnp.zeros_like(a)

    def is_zero(self, a):
        return jnp.all(a == 0, axis=0)

    def _repr_le(self, a, b):
        le = jnp.ones(jnp.broadcast_shapes(a.shape[1:], b.shape[1:]), dtype=bool)
        decided = jnp.zeros_like(le)
        for i in range(self.L - 1, -1, -1):
            ai, bi = a[i], b[i]
            le = jnp.where(decided, le, jnp.where(ai != bi, ai < bi, le))
            decided = jnp.logical_or(decided, ai != bi)
        return le


class LimbBinaryOps(_PlanarTupleMixin, FieldOps):
    """GF(2^m) for m > 32: bit-limb carry-less arithmetic on PLANAR
    (L, *elem_shape) storage. All arithmetic runs on limb TUPLES (the
    protocol from _PlanarTupleMixin) so lax.scan/fori_loop carries in
    composite kernels (pow ladders, Horner, poly divmod) never pay a
    per-iteration stack/slice of joined storage."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.L = meta.storage_width
        self.m = meta.degree
        self.dt = jnp.dtype(meta.internal_dtype)
        self.MASK = (1 << LIMB_BITS) - 1
        # Product needs 2m-1 bits
        self.PL = -(-(2 * self.m - 1) // LIMB_BITS)

    def add(self, a, b):
        # via the tuple protocol: mixed-rank planar operands ((w,) scalar
        # vs (w, ...) array) must broadcast on ELEMENT axes, which a raw
        # storage XOR (trailing-aligned) gets wrong
        return self.join_limbs(self.add_t(self.split_limbs(a), self.split_limbs(b)))

    subtract = add

    def negative(self, a):
        return a

    def add_t(self, a, b):
        d, e, _ = self._bcast2_t(a, b)
        return tuple(dk ^ ek for dk, ek in zip(d, e))

    subtract_t = add_t

    def negative_t(self, a):
        return a

    def _get_bit(self, x, i):
        return (x[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1

    @functools.cached_property
    def _reduce_consts(self):
        """NumPy-only (cached across traces): scanned reduction rows
        f << (i-m) for the 2m-1-bit product, high bit first, plus the
        (static) set of limb indices the scanned bit can live in."""
        m, PL = self.m, self.PL
        f = self.meta.irreducible_poly_int
        idxs = list(range(2 * m - 2, m - 1, -1))
        consts = np.stack(
            [np.asarray(int_to_limbs(f << (i - m), PL)) for i in idxs]
        ).astype(np.uint32)
        r_word = np.asarray([i // LIMB_BITS for i in idxs])
        r_sh = np.asarray([i % LIMB_BITS for i in idxs], dtype=np.uint32)
        cand = sorted({int(w) for w in r_word})
        return consts, r_word, r_sh, cand

    def _reduce_t(self, acc):
        """Reduce a PL-plane tuple (2m-1-bit value) mod f -> L planes.

        lax.scan over the m-1 high bits so the XLA graph is O(1) in m (an
        unrolled m=100 bit loop is a compile-time hazard). The scanned bit's
        limb index is dynamic, but ranges over only ~L+1 candidates — a
        short where-chain instead of a stacked-carry jnp.take."""
        consts, r_word, r_sh, cand = self._reduce_consts

        def red_step(acc, xs):
            const, wi, sh = xs
            word = jnp.zeros_like(acc[0])
            for k in cand:
                word = jnp.where(wi == k, acc[k], word)
            mask = jnp.uint32(0) - ((word >> sh) & 1)  # all-ones select
            return tuple(ak ^ (const[k] & mask) for k, ak in enumerate(acc)), None

        acc, _ = jax.lax.scan(
            red_step, tuple(acc), (jnp.asarray(consts), jnp.asarray(r_word), jnp.asarray(r_sh))
        )
        return acc[: self.L]

    def multiply_t(self, a, b):
        """Carry-less multiply + reduction as lax.scans over limb tuples."""
        m, L, PL = self.m, self.L, self.PL
        d, e, shape = self._bcast2_t(a, b)
        zero = jnp.zeros(shape, jnp.uint32)
        acc = (zero,) * PL
        sa = tuple(d) + (zero,) * (PL - L)
        bwb = jnp.stack(e)  # read-only scan input: one stack, not a carry

        word_idx = jnp.asarray(np.arange(m) // LIMB_BITS)
        bit_sh = jnp.asarray(np.arange(m) % LIMB_BITS, dtype=np.uint32)

        def mul_step(carry, xs):
            acc, sa = carry
            wi, sh = xs
            word = jnp.take(bwb, wi, axis=0)
            mask = jnp.uint32(0) - ((word >> sh) & 1)  # all-ones select, no mult
            acc = tuple(ak ^ (sk & mask) for ak, sk in zip(acc, sa))
            sa = tuple(
                ((sa[k] << 1) & self.MASK) | (sa[k - 1] >> (LIMB_BITS - 1))
                if k
                else (sa[0] << 1) & self.MASK
                for k in range(PL)
            )
            return (acc, sa), None

        (acc, _), _ = jax.lax.scan(mul_step, (acc, sa), (word_idx, bit_sh))
        return self._reduce_t(acc)

    def square_t(self, a):
        """GF(2) squaring has no cross terms: spread each limb's bits with
        interleaved zeros (4 SWAR steps), then one reduction scan — ~m scan
        steps total vs 2m for multiply_t, halving every pow-ladder square."""
        L, PL = self.L, self.PL
        aw = [x.astype(jnp.uint32) for x in a]
        shape = jnp.broadcast_shapes(*[x.shape for x in aw])
        acc = [jnp.zeros(shape, jnp.uint32)] * PL
        for k in range(L):
            x = aw[k]
            x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
            x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
            x = (x | (x << 2)) & jnp.uint32(0x33333333)
            x = (x | (x << 1)) & jnp.uint32(0x55555555)
            if 2 * k < PL:
                acc[2 * k] = acc[2 * k] | jnp.broadcast_to(x & self.MASK, shape)
            if 2 * k + 1 < PL:
                acc[2 * k + 1] = acc[2 * k + 1] | jnp.broadcast_to(x >> LIMB_BITS, shape)
        return self._reduce_t(tuple(acc))

    # -- planar-storage entry points: split, compute, join. XLA cancels
    # adjacent join/split pairs between chained ops.

    def multiply(self, a, b):
        return self.join_limbs(self.multiply_t(self.split_limbs(a), self.split_limbs(b)))

    def square(self, a):
        return self.join_limbs(self.square_t(self.split_limbs(a)))

    def power_static(self, a, e: int):
        # Large static exponents use the compact ladder (small XLA graph);
        # small ones stay unrolled (fewer runtime multiplies).
        if abs(e).bit_length() > 16:
            return self._pow_int_compact(a, e)
        return super().power_static(a, e)

    def reciprocal(self, a):
        # Compact ladder: an unrolled Itoh-Tsujii chain of ~m full clmuls
        # would produce an enormous XLA graph for m > 32.
        return self._pow_int_compact(a, 2**self.m - 2)

    def one_like(self, a):
        one = jnp.zeros_like(a)
        return one.at[0].set(1)

    def zero_like(self, a):
        return jnp.zeros_like(a)

    def is_zero(self, a):
        return jnp.all(a == 0, axis=0)

    def _repr_le(self, a, b):
        le = jnp.ones(jnp.broadcast_shapes(a.shape[1:], b.shape[1:]), dtype=bool)
        decided = jnp.zeros_like(le)
        for i in range(self.L - 1, -1, -1):
            ai, bi = a[i], b[i]
            le = jnp.where(decided, le, jnp.where(ai != bi, ai < bi, le))
            decided = jnp.logical_or(decided, ai != bi)
        return le

    def sqrt(self, a):
        # a^(2^(m-1)) via the compact ladder
        return self._pow_int_compact(a, 2 ** (self.m - 1))



class GoldilocksOps(LimbPrimeOps):
    """Specialized kernels for p = 2^64 - 2^32 + 1 ("Goldilocks").

    Pure 32-bit-lane arithmetic on the 4 x uint16 limb storage, with no
    64-bit integer op: the 128-bit product is built
    from sixteen native 16x16->32 multiplies (column sums stay < 2^19) and
    reduced with 2^64 = 2^32 - 1, 2^96 = -1 (mod p) as signed 16-bit-digit
    column folds. No uint64 appears anywhere on the hot path.
    """

    P_INT = 2**64 - 2**32 + 1
    _P_DIGS = (1, 0, 0xFFFF, 0xFFFF)  # p, base-2^16 little-endian

    @staticmethod
    def _prop4(cols):
        """Signed carry propagation over 4 int32 columns -> (digits, carry).

        `>> 16` on int32 is arithmetic, so negative columns borrow correctly.
        """
        digs = []
        carry = jnp.zeros_like(cols[0])
        for c in cols:
            t = c + carry
            digs.append(t & 0xFFFF)
            carry = t >> 16
        return digs, carry

    def _cond_sub_p_t(self, digs):
        """digs (int32, < 2^16 each, value < 2^64) -> canonical limb tuple."""
        borrow = jnp.zeros_like(digs[0])
        diff = []
        for dk, pk in zip(digs, self._P_DIGS):
            t = dk - pk - borrow
            diff.append(t & 0xFFFF)
            borrow = (t >> 16) & 1
        ge = borrow == 0
        return tuple(jnp.where(ge, df, dg) for df, dg in zip(diff, digs))

    def _reduce_digits_128_t(self, g):
        """8 int32 digits (128-bit value) -> canonical 4-limb tuple mod p.

        n = lo + 2^64 h0 + 2^96 h1 = lo + (2^32 - 1) h0 - h1 (mod p).
        Two fold+propagate rounds absorb the +-1 end carry (value stays in
        (-2^33, 2^65) after round one, [0, 2^64) after round two).
        """
        cols = [g[0] - g[4] - g[6], g[1] - g[5] - g[7], g[2] + g[4], g[3] + g[5]]
        for _ in range(2):
            digs, carry = self._prop4(cols)
            # carry * 2^64 = carry * (2^32 - 1) (mod p)
            cols = [digs[0] - carry, digs[1], digs[2] + carry, digs[3]]
        digs, _ = self._prop4(cols)  # end carry is provably 0 here
        return self._cond_sub_p_t(digs)

    # -- limb-tuple protocol (the native form of every Goldilocks kernel).
    # Storage is planar (4, *elem): each limb plane is a full-lane int32
    # array, so split/join are free major-axis slices / one stack, and
    # XLA cancels adjacent join/split pairs so chained ops and loop
    # carries stay in the fast layout throughout.

    def split_limbs(self, a):
        return tuple(a[k].astype(jnp.int32) for k in range(4))

    def join_limbs(self, t):
        shape = jnp.broadcast_shapes(*[x.shape for x in t])
        return jnp.stack([jnp.broadcast_to(x, shape) for x in t], axis=0).astype(self.dt)

    def one_like_t(self, t):
        z = jnp.zeros_like(t[0])
        return (jnp.ones_like(t[0]), z, z, z)

    def multiply_t(self, a, b, unroll: bool = False):
        # All-u32 16x16->32 products. (unroll accepted for LimbPrimeOps API
        # parity — this path is already the fully fused elementwise loop.)
        d, e, shape = self._bcast2_t(a, b)
        zero = jnp.zeros(shape, jnp.uint32)
        cols = [zero] * 8
        for i in range(4):
            for j in range(4):
                prod = d[i] * e[j]  # native 16x16 -> 32
                k = i + j
                cols[k] = cols[k] + (prod & 0xFFFF)
                cols[k + 1] = cols[k + 1] + (prod >> 16)
        g = []
        carry = zero
        for k in range(8):
            t = cols[k] + carry
            g.append(t & 0xFFFF)
            carry = t >> 16
        # product < 2^128, so the final carry is 0
        return self._reduce_digits_128_t([x.astype(jnp.int32) for x in g])

    def square_t(self, a):
        d = [x.astype(jnp.uint32) for x in a]
        zero = jnp.zeros(d[0].shape, jnp.uint32)
        cols = [zero] * 8
        for i in range(4):
            for j in range(i, 4):
                prod = d[i] * d[j]
                lo, hi = prod & 0xFFFF, prod >> 16
                k = i + j
                if i == j:
                    cols[k] = cols[k] + lo
                    cols[k + 1] = cols[k + 1] + hi
                else:
                    cols[k] = cols[k] + lo + lo
                    cols[k + 1] = cols[k + 1] + hi + hi
        g = []
        carry = zero
        for k in range(8):
            t = cols[k] + carry
            g.append(t & 0xFFFF)
            carry = t >> 16
        return self._reduce_digits_128_t([x.astype(jnp.int32) for x in g])

    def add_t(self, a, b):
        d = [x.astype(jnp.int32) for x in a]
        e = [x.astype(jnp.int32) for x in b]
        cols = [d[k] + e[k] for k in range(4)]
        digs, carry = self._prop4(cols)  # carry in {0, 1}
        cols = [digs[0] - carry, digs[1], digs[2] + carry, digs[3]]
        digs, _ = self._prop4(cols)
        return self._cond_sub_p_t(digs)

    def subtract_t(self, a, b):
        d = [x.astype(jnp.int32) for x in a]
        e = [x.astype(jnp.int32) for x in b]
        cols = [d[k] - e[k] for k in range(4)]
        digs, carry = self._prop4(cols)  # carry in {-1, 0}
        cols = [digs[0] - carry, digs[1], digs[2] + carry, digs[3]]
        digs, _ = self._prop4(cols)
        return self._cond_sub_p_t(digs)

    def negative_t(self, a):
        d = [x.astype(jnp.int32) for x in a]
        cols = [self._P_DIGS[k] - d[k] for k in range(4)]
        digs, _ = self._prop4(cols)  # p - a in [1, p], no end carry
        neg = self._cond_sub_p_t(digs)  # maps a=0 (value p) back to 0
        return neg

    # -- stacked-storage entry points: split, compute, join. XLA cancels
    # the join/split pairs between chained ops.

    def multiply(self, a, b):
        return self.join_limbs(self.multiply_t(self.split_limbs(a), self.split_limbs(b)))

    def square(self, a):
        return self.join_limbs(self.square_t(self.split_limbs(a)))

    def add(self, a, b):
        return self.join_limbs(self.add_t(self.split_limbs(a), self.split_limbs(b)))

    def subtract(self, a, b):
        return self.join_limbs(self.subtract_t(self.split_limbs(a), self.split_limbs(b)))

    def negative(self, a):
        return self.join_limbs(self.negative_t(self.split_limbs(a)))

    def reciprocal(self, a):
        return self._pow_int_compact(a, self.P_INT - 2)


# ======================================================================
# Lookup-table overlay (order <= 2^20, int storage)
# ======================================================================

class LookupOps:
    """Mixin-style wrapper: EXP/LOG-table gathers for mul/div/recip/pow/log;
    everything else delegates to the calculate ops. The gathers are plain
    XLA gathers from tables of at most 2^21 int32 entries (orders up to the
    reference's lookup ceiling, src/galois/_domains/_meta.py:39-48). Lookup
    mode is a performance mode; results are identical to calculate mode."""

    def __init__(self, calc: FieldOps):
        self._calc = calc
        self.meta = calc.meta
        exp, log = build_exp_log(self.meta)
        # NumPy (not jnp): cached across traces — see OddExtOps note.
        self.EXP = np.asarray(exp, dtype=np.int32)  # length 2(q-1)
        self.LOG = np.asarray(log, dtype=np.int32)  # length q
        self.dt = jnp.dtype(self.meta.internal_dtype)

    def __getattr__(self, name):
        return getattr(self._calc, name)

    def _take(self, table, idx):
        return jnp.take(jnp.asarray(table), idx.astype(jnp.int32), axis=0)

    def multiply(self, a, b):
        la = self._take(self.LOG, a)
        lb = self._take(self.LOG, b)
        r = self._take(self.EXP, la + lb)
        zero = jnp.logical_or(a == 0, b == 0)
        return jnp.where(zero, 0, r).astype(self.dt)

    def square(self, a):
        return self.multiply(a, a)

    def reciprocal(self, a):
        q = self.meta.order
        la = self._take(self.LOG, a)
        return self._take(self.EXP, (q - 1) - la).astype(self.dt)

    def divide(self, a, b):
        q = self.meta.order
        la = self._take(self.LOG, a)
        lb = self._take(self.LOG, b)
        r = self._take(self.EXP, la + ((q - 1) - lb))
        return jnp.where(a == 0, 0, r).astype(self.dt)

    def power(self, a, e):
        # jnp remainder is non-negative, so negative exponents work directly:
        # a^e = alpha^(log(a)*e mod (q-1)). Reduce e mod q-1 first so the
        # int64 product log(a)*e cannot overflow (log < 2^20, e_red < 2^20).
        q = self.meta.order
        e = jnp.asarray(e, dtype=jnp.int64)
        e_red = e % (q - 1)
        la = self._take(self.LOG, a).astype(jnp.int64)
        idx = (la * e_red) % (q - 1)
        r = self._take(self.EXP, idx.astype(jnp.int32))
        r = jnp.where(jnp.asarray(a == 0), jnp.where(e == 0, 1, 0), r)
        return r.astype(self.dt)

    def power_words(self, a, words):
        # Lookup fields have q <= 2^20, so callers reduce exponents mod q-1
        # into a single word.
        assert len(words) == 1
        return self.power(a, words[0])

    def power_static(self, a, e: int):
        # Reduce mod q-1 first (exponents may exceed 64 bits), but keep the
        # 0^e semantics of the true exponent.
        q = self.meta.order
        e_red = e % (q - 1)
        r = self.power(a, jnp.asarray(e_red, dtype=jnp.int64))
        if e != 0 and e_red == 0:
            r = jnp.where(jnp.asarray(a == 0), 0, r).astype(self.dt)
        return r

    def log_alpha(self, a):
        """Discrete log base the field's primitive element."""
        return self._take(self.LOG, a).astype(jnp.int64)

    def sqrt(self, a):
        q = self.meta.order
        la = self._take(self.LOG, a).astype(jnp.int64)
        if q % 2 == 0:
            # q-1 odd: inverse of 2 mod q-1 is q/2
            idx = (la * (q // 2)) % (q - 1)
            r = self._take(self.EXP, idx.astype(jnp.int32))
            return jnp.where(a == 0, 0, r).astype(self.dt)
        # even log -> EXP[l/2]; pick canonical (smaller int repr) root
        half = la // 2
        r1 = self._take(self.EXP, half.astype(jnp.int32))
        r2 = self._calc.negative(r1.astype(self.dt))
        r = jnp.where(r1.astype(jnp.int64) <= r2.astype(jnp.int64), r1.astype(self.dt), r2)
        return jnp.where(a == 0, 0, r).astype(self.dt)


# ======================================================================
# Factory
# ======================================================================

@functools.lru_cache(maxsize=256)  # bounded: see codes/_decoder.py::make_decoder
def power_static_jit(meta: FieldMeta, mode: str, e: int):
    """Cached jitted ``a -> a**e`` for a static exponent.

    ``jax.jit(lambda a: ...)`` at each call site creates a fresh cache entry
    per CALL (new lambda identity), retracing and recompiling every time;
    repeated ``x**3`` / Fermat inversions must reuse one executable."""
    ops = get_ops(meta, mode)
    return jax.jit(lambda a: ops.power_static(a, e))


@functools.lru_cache(maxsize=None)
def get_ops(meta: FieldMeta, mode: str):
    """Return the kernel object for (field, compile mode).

    mode: "jit-calculate" or "jit-lookup" ("python-calculate" is handled
    host-side in fields/_tables.py).
    """
    p, m = meta.characteristic, meta.degree
    if meta.storage == STORAGE_LIMBS:
        if p == 2:
            calc = LimbBinaryOps(meta)
        elif p == 2**64 - 2**32 + 1:
            calc = GoldilocksOps(meta)
        else:
            calc = LimbPrimeOps(meta)
    elif m == 1:
        calc = GF2Ops(meta) if p == 2 else PrimeOps(meta)
    elif p == 2:
        calc = BinaryExtOps(meta)
    else:
        calc = OddExtOps(meta)

    if mode == "jit-lookup":
        if meta.storage != STORAGE_INT:
            raise ValueError(f"{meta.name} does not support lookup mode.")
        return LookupOps(calc)
    return calc
