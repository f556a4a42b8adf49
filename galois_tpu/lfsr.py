"""Linear-feedback shift registers and Berlekamp-Massey.

API parity with the reference (reference: src/galois/_lfsr.py:27-1702).
On device: `step(n)` runs one `lax.scan` of n clock ticks with the state as
the carry — replacing the reference's sequential Numba loops — so stepping is
a single device computation regardless of n, and batches/vmaps cleanly.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .fields._array import FieldArray
from .fields._meta import STORAGE_INT, FieldMeta
from .ops._kernels import get_ops
from .polys._poly import Poly

__all__ = ["FLFSR", "GLFSR", "berlekamp_massey"]


def _field_dot(ops, a, b, ax: int):
    """Field dot product of two small 1-D element arrays (element axis ax:
    0 for int/digit storage, 1 for planar limb storage whose limb axis
    leads)."""
    out = ops.multiply(a, b)
    n = out.shape[ax]
    while n > 1:
        half = n // 2
        lo = jax.lax.slice_in_dim(out, 0, half, axis=ax)
        hi = jax.lax.slice_in_dim(out, half, 2 * half, axis=ax)
        rest = jax.lax.slice_in_dim(out, 2 * half, n, axis=ax)
        out = jnp.concatenate([ops.add(lo, hi), rest], axis=ax)
        n = half + (n - 2 * half)
    return jax.lax.index_in_dim(out, 0, axis=ax, keepdims=False)


@functools.lru_cache(maxsize=64)  # bounded: keyed on step count (see codes/_decoder.py::make_decoder)
def _step_kernel(meta: FieldMeta, mode: str, kind: str, direction: str, steps: int):
    ops = get_ops(meta, mode)
    # Element axis of the raw storage arrays: planar limb storage keeps the
    # limb axis LEADING, so its element axis is 1; int/digit storage lead
    # with the element axis.
    ax = 1 if meta.storage_first else 0

    def _at(x, i):
        return jax.lax.index_in_dim(x, i, axis=ax, keepdims=False)

    def _sl(x, a, b):
        return jax.lax.slice_in_dim(x, a, b, axis=ax)

    def _exp(x):
        return jnp.expand_dims(x, ax)

    def _bcast_elem(f, like):
        # broadcast a single element f across like's element axis
        return jnp.broadcast_to(_exp(f), like.shape)

    def fib_fwd(state, taps):
        def tick(state, _):
            f = _field_dot(ops, state, taps, ax)
            y = _at(state, state.shape[ax] - 1)
            state = jnp.concatenate([_exp(f), _sl(state, 0, state.shape[ax] - 1)], axis=ax)
            return state, y

        return jax.lax.scan(tick, state, None, length=steps)

    def fib_bwd(state, taps):
        def tick(state, _):
            f = _at(state, 0)
            shifted = _sl(state, 1, state.shape[ax])
            s = f
            if shifted.shape[ax] > 0:
                s = ops.subtract(s, _field_dot(ops, shifted, _sl(taps, 0, taps.shape[ax] - 1), ax))
            s = ops.multiply(s, ops.reciprocal(_at(taps, taps.shape[ax] - 1)))
            state = jnp.concatenate([shifted, _exp(s)], axis=ax)
            return state, s

        return jax.lax.scan(tick, state, None, length=steps)

    def gal_fwd(state, taps):
        def tick(state, _):
            f = _at(state, state.shape[ax] - 1)
            fx = ops.multiply(_bcast_elem(f, taps), taps)
            shifted = jnp.concatenate(
                [_exp(ops.zero_like(f)), _sl(state, 0, state.shape[ax] - 1)], axis=ax
            )
            state = ops.add(shifted, fx)
            return state, f

        return jax.lax.scan(tick, state, None, length=steps)

    def gal_bwd(state, taps):
        def tick(state, _):
            f = ops.multiply(_at(state, 0), ops.reciprocal(_at(taps, 0)))
            fx = ops.multiply(_bcast_elem(f, taps), taps)
            upper = ops.subtract(_sl(state, 1, state.shape[ax]), _sl(fx, 1, fx.shape[ax]))
            state = jnp.concatenate([upper, _exp(f)], axis=ax)
            return state, f

        return jax.lax.scan(tick, state, None, length=steps)

    fns = {
        ("fibonacci", "forward"): fib_fwd,
        ("fibonacci", "backward"): fib_bwd,
        ("galois", "forward"): gal_fwd,
        ("galois", "backward"): gal_bwd,
    }
    return jax.jit(fns[(kind, direction)])


class _LFSR:
    _kind = "fibonacci"

    def __init__(self, feedback_poly: Poly, state=None):
        if not isinstance(feedback_poly, Poly):
            raise TypeError(f"Argument 'feedback_poly' must be a Poly, not {type(feedback_poly)}.")
        if int(feedback_poly.coefficients()[-1]) != 1:
            raise ValueError(
                f"Argument 'feedback_poly' must have a 0-th degree term of 1, not {feedback_poly}."
            )
        self._field = feedback_poly.field
        self._feedback_poly = feedback_poly
        self._characteristic_poly = feedback_poly.reverse()
        self._order = feedback_poly.degree

        # c(x) = x^n + a_1 x^(n-1) + ... + a_n; taps per reference convention
        # (reference: src/galois/_lfsr.py:48-55)
        c = self._characteristic_poly.coefficients()
        taps = -c[1:]
        if self._kind == "galois":
            taps = type(taps)(np.asarray(taps, dtype=object)[::-1])
        self._taps = taps

        if state is None:
            state = self._field.Ones(self._order)
        self._initial_state = self._verify_state(state)
        self._state = self._initial_state.copy()

    @classmethod
    def Taps(cls, taps, state=None):
        if not isinstance(taps, FieldArray):
            raise TypeError(f"Argument 'taps' must be a FieldArray, not {type(taps)}.")
        field = type(taps)
        neg = -taps
        if cls._kind == "fibonacci":
            # f(x) = 1 + a_1 x + ... + a_n x^n
            coeffs = np.concatenate([[1], np.asarray(neg, dtype=object)])
            feedback_poly = Poly(coeffs[::-1].tolist(), field=field)
        else:
            coeffs = np.concatenate([[1], np.asarray(neg, dtype=object)])
            characteristic_poly = Poly(coeffs.tolist(), field=field)
            feedback_poly = characteristic_poly.reverse()
        return cls(feedback_poly, state=state)

    def _verify_state(self, state):
        s = self._field(state)
        if s.size != self._order:
            raise ValueError(
                f"Argument 'state' must have size {self._order}, not {s.size}."
            )
        return s.flatten()

    def reset(self, state=None):
        self._state = self._initial_state.copy() if state is None else self._verify_state(state)

    # -- properties --
    @property
    def field(self):
        return self._field

    @property
    def feedback_poly(self) -> Poly:
        return self._feedback_poly

    @property
    def characteristic_poly(self) -> Poly:
        return self._characteristic_poly

    @property
    def order(self) -> int:
        return self._order

    @property
    def taps(self):
        return self._taps

    @property
    def initial_state(self):
        return self._initial_state.copy()

    @property
    def state(self):
        return self._state.copy()

    # -- stepping --
    def step(self, steps: int = 1):
        steps = int(steps)
        if steps == 0:
            return self._field([])
        direction = "forward" if steps > 0 else "backward"
        if direction == "backward" and int(self.characteristic_poly.coefficients()[-1]) == 0:
            # reference parity (src/galois/_lfsr.py:129-134)
            raise ValueError(
                "Can only step the shift register backwards if the a_n tap is "
                f"non-zero, not c(x) = {self.characteristic_poly}."
            )
        n = abs(steps)
        cls = self._field
        mode = cls._mode if cls._mode != "python-calculate" else cls._meta.default_ufunc_mode
        kern = _step_kernel(cls._meta, mode, self._kind, direction, n)
        new_state, y = kern(self._state._data, self._taps._data)
        if cls._meta.storage_first:
            # lax.scan stacks per-step outputs on a NEW leading axis, giving
            # (steps, w, ...); planar storage wants the limb axis leading.
            y = jnp.moveaxis(y, 0, 1)
        self._state = cls._view(new_state, self._state._dtype)
        out = cls._view(y, self._state._dtype)
        if n == 1:
            out = out[0]  # reference parity: single steps return 0-D scalars
        return out

    def __repr__(self):
        from ._options import printoptions

        name = "Fibonacci" if self._kind == "fibonacci" else "Galois"
        with printoptions(coeffs="asc"):
            return f"<{name} LFSR: f(x) = {self.feedback_poly} over {self.field.name}>"

    def __str__(self):
        name = "Fibonacci" if self._kind == "fibonacci" else "Galois"
        lines = [
            f"{name} LFSR:",
            f"  field: {self.field.name}",
            f"  feedback_poly: {self.feedback_poly}",
            f"  characteristic_poly: {self.characteristic_poly}",
            f"  taps: {self.taps}",
            f"  order: {self.order}",
            f"  state: {self.state}",
            f"  initial_state: {self.initial_state}",
        ]
        return "\n".join(lines)


class FLFSR(_LFSR):
    """Fibonacci linear-feedback shift register
    (reference: src/galois/_lfsr.py:182)."""

    _kind = "fibonacci"

    def to_galois_lfsr(self) -> "GLFSR":
        """Equivalent Galois LFSR: G_0(x) = floor(Y(x) P(x) / x^n) where Y is
        the next-n-outputs polynomial (reference: src/galois/_lfsr.py:491)."""
        n = self.order
        state = np.asarray(self.state, dtype=object)
        Y = Poly(state[::-1].tolist(), field=self.field)
        G0 = (Y * self.characteristic_poly) // Poly.Degrees([n], field=self.field)
        g = np.asarray(G0.coefficients(n), dtype=object)[::-1]  # ascending g_0..g_{n-1}
        return GLFSR(self.feedback_poly, state=g.tolist())


class GLFSR(_LFSR):
    """Galois linear-feedback shift register
    (reference: src/galois/_lfsr.py:852)."""

    _kind = "galois"

    def to_fibonacci_lfsr(self) -> FLFSR:
        """Equivalent Fibonacci LFSR: its state is the next n outputs of this
        register, reversed (reference: src/galois/_lfsr.py:1159)."""
        clone = GLFSR(self.feedback_poly, state=self.state)
        y = clone.step(self.order)
        state = np.asarray(y, dtype=object)[::-1]
        return FLFSR(self.feedback_poly, state=state.tolist())


@functools.lru_cache(maxsize=32)
def _bm_kernel(meta: FieldMeta, mode: str, n: int):
    """Branch-free Berlekamp-Massey as one lax.scan over the sequence.

    The host discrepancy/update loop is O(N*L) Python field ops — minutes at
    N ~ 10^4; here each of the N steps is one K-lane field dot plus masked
    selects, so long sequences run as a single device program (the
    decoder-internal form in codes/_decoder.py is the fixed-(d-1) special
    case of the same recurrence)."""
    ops = get_ops(meta, mode)
    # Capacity must cover ANY reachable connection poly: linear complexity
    # can reach n itself (e.g. an impulse at the end of an all-zero prefix
    # gives C(x) = x^n + ... with L = n), and the x^m B(x) update can touch
    # degree t <= n-1 mid-run. K = n + 1 holds every intermediate exactly.
    K = n + 1

    def run(seq):
        dt = seq.dtype
        pad = jnp.zeros((K - 1,), dt)
        padded = jnp.concatenate([pad, seq])
        idx = jnp.arange(K)
        one = ops.one_like(jnp.zeros((), dt))
        c0 = jnp.zeros((K,), dt).at[0].set(one)

        def step(carry, t):
            c, b, L, m, bcoef = carry
            win = jax.lax.dynamic_slice(padded, (t,), (K,))
            d = _field_dot(ops, c, win[::-1], 0)  # sum_i c[i] * seq[t-i]
            coef = ops.multiply(d, ops.reciprocal(bcoef))  # bcoef != 0 invariant
            # x^m * B(x): shift coefficients up by m, zero-fill below
            shifted = jnp.where(idx >= m, jnp.roll(b, m), jnp.zeros_like(b))
            c_new = ops.subtract(c, ops.multiply(jnp.broadcast_to(coef, (K,)), shifted))
            d_zero = ops.is_zero(d)
            relen = (~d_zero) & (2 * L <= t)
            c_out = jnp.where(d_zero, c, c_new)
            b_out = jnp.where(relen, c, b)
            bcoef_out = jnp.where(relen, d, bcoef)
            L_out = jnp.where(relen, t + 1 - L, L)
            m_out = jnp.where(relen, jnp.int32(1), m + jnp.int32(1))
            return (c_out, b_out, L_out, m_out, bcoef_out), None

        init = (c0, c0, jnp.int32(0), jnp.int32(1), one)
        (c, _, L, _, _), _ = jax.lax.scan(step, init, jnp.arange(n, dtype=jnp.int32))
        return c, L

    return jax.jit(run)


def berlekamp_massey(sequence, output: str = "characteristic"):
    """Berlekamp-Massey: minimal LFSR of a linear recurrent sequence
    (reference: src/galois/_lfsr.py:1502-1619)."""
    if not isinstance(sequence, FieldArray):
        raise TypeError(f"Argument 'sequence' must be a FieldArray, not {type(sequence)}.")
    if sequence.ndim != 1:
        raise ValueError(f"Argument 'sequence' must be 1-D, not {sequence.ndim}-D.")
    if output not in ("characteristic", "connection", "fibonacci", "galois"):
        raise ValueError(
            f"Argument 'output' must be in ['characteristic', 'connection', 'fibonacci', 'galois'], not {output!r}."
        )
    field = type(sequence)
    from .fields._hostfield import get_host_field

    hf = get_host_field(field._meta)

    # Long sequences: one device scan instead of the O(N*L) host loop. The
    # host int conversion below is deliberately AFTER this early return so
    # the device path never pays an O(N) per-element D2H round trip whose
    # result would be discarded.
    if (
        field._meta.storage == STORAGE_INT
        and len(sequence) >= 512
        and field._mode != "python-calculate"
    ):
        kern = _bm_kernel(field._meta, "jit-calculate", len(sequence))
        c_arr, L_dev = kern(sequence._data)
        L = int(L_dev)
        c = [int(v) for v in np.asarray(c_arr[: L + 1], dtype=np.int64)]
        return _bm_output(sequence, c, L, field, output)

    # Classic discrepancy/update form.
    seq = [int(v) for v in np.asarray(sequence, dtype=object)]
    N = len(seq)
    c = [1]  # connection poly, ascending
    b = [1]
    L, m = 0, 1
    bcoef = 1
    for t in range(N):
        d = seq[t]
        for i in range(1, L + 1):
            if i < len(c) and c[i]:
                d = hf.add(d, hf.multiply(c[i], seq[t - i]))
        if d == 0:
            m += 1
        elif 2 * L <= t:
            temp = list(c)
            coef = hf.multiply(d, hf.reciprocal(bcoef))
            c = c + [0] * (len(b) + m - len(c)) if len(b) + m > len(c) else c
            for i, bi in enumerate(b):
                if bi:
                    c[i + m] = hf.subtract(c[i + m], hf.multiply(coef, bi))
            L = t + 1 - L
            b = temp
            bcoef = d
            m = 1
        else:
            coef = hf.multiply(d, hf.reciprocal(bcoef))
            if len(b) + m > len(c):
                c = c + [0] * (len(b) + m - len(c))
            for i, bi in enumerate(b):
                if bi:
                    c[i + m] = hf.subtract(c[i + m], hf.multiply(coef, bi))
            m += 1

    return _bm_output(sequence, c, L, field, output)


def _bm_output(sequence, c, L, field, output):
    """Shared tail: ascending connection coefficients -> requested form."""
    connection_poly = Poly(c[: L + 1][::-1], field=field)
    if output == "characteristic":
        return connection_poly.reverse()
    if output == "connection":
        return connection_poly

    state = np.asarray(sequence, dtype=object)[: connection_poly.degree][::-1]
    fib = FLFSR(connection_poly, state=state.tolist())
    if output == "fibonacci":
        return fib
    return fib.to_galois_lfsr()
