"""Number-theoretic transform / finite-field FFT.

Mixed-radix Cooley-Tukey: each level reshapes (..., N) ->
(..., M, r), recurses on the size-M transforms, applies precomputed twiddle
factors, and combines with an r x r DFT matrix contraction. All twiddle/DFT
tables are computed once per (field, N) and embedded as device constants;
there is no bit-reversal pass and no data-dependent control flow.

This replaces the reference's single-threaded staged-loop kernel
(reference: src/galois/_domains/_function.py:170-392) with a formulation
XLA can fuse and (for the contraction) run as int8 matmuls; the multi-device
version lives in parallel/_ntt_sharded.py.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import FieldMeta
from ..nt import factors as int_factors
from ._kernels import get_ops

__all__ = ["fft_data", "ifft_data", "field_fft", "field_ifft", "FFTPlan"]

_MAX_BASE = 64  # transforms at or below this size use a direct DFT matmul



def _trace_state_clean() -> bool:
    """True when not under an active jax trace (version-tolerant)."""
    try:
        from jax._src.core import trace_state_clean

        return trace_state_clean()
    except Exception:  # pragma: no cover - jax internals moved
        return True

def _trailing_nd(meta) -> int:
    """Element-axis offset from the END of a storage array. Digit storage
    keeps a trailing (m,) axis; planar limb storage leads with (w,), which
    rides through all trailing-axis reshapes as a batch axis; int storage
    has no storage axis."""
    return 1 if meta.storage == "digits" else 0




def _radix_schedule(N: int) -> List[int]:
    """Factor N into a list of radices, largest-first, leaving a base <= 64.

    Prefers big radices so the recursion is shallow (fewer memory passes)."""
    primes, exponents = int_factors(N)
    fs: List[int] = []
    for p, e in zip(primes, exponents):
        fs += [p] * e
    fs.sort(reverse=True)
    # Greedily merge small factors into radices <= _MAX_BASE
    radices: List[int] = []
    cur = 1
    for f in sorted(fs):
        if cur * f <= _MAX_BASE:
            cur *= f
        else:
            radices.append(cur)
            cur = f
    if cur > 1:
        radices.append(cur)
    return sorted(radices, reverse=True)


class FFTPlan:
    """Precomputed tables for a size-N field FFT over GF(q) (N | q-1)."""

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str):
        self.meta = meta
        self.N = N
        self.mode = mode
        self.ops = get_ops(meta, mode)
        from ..fields._hostfield import get_host_field

        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError(f"omega must be an N-th root of unity.")

        # Host power table of omega — built by NumPy doubling when the field
        # is small, else by Python pow (prime fields) — then placed on device.
        self.pw = self._build_power_table(hf, omega_int, N)

        # Per-level structure: list of (r, M, twiddle const (M, r), W const (r, r))
        self.levels: List[Tuple[int, int, jnp.ndarray, jnp.ndarray]] = []
        radices = _radix_schedule(N)
        if len(radices) == 1:
            self.base = N
            self.base_W = self._dft_matrix(N, stride=1)
            return
        size = N
        stride = 1
        for r in radices[:-1]:
            M = size // r
            k = np.arange(M).reshape(-1, 1)
            j = np.arange(r).reshape(1, -1)
            tw_idx = (k * j * stride) % N
            twiddle = self._gather(tw_idx)
            W = self._dft_matrix(r, stride=stride * M)
            self.levels.append((r, M, twiddle, W))
            size = M
            stride *= r
        self.base = size
        self.base_W = self._dft_matrix(size, stride=stride)

    def _build_power_table(self, hf, omega: int, N: int) -> np.ndarray:
        """pw[k] = omega^k as int reprs (NumPy int64/object), length N."""
        q = self.meta.order
        if q <= 2**62 and self.meta.is_prime_field:
            p = self.meta.characteristic
            pw = np.empty(N, dtype=object)
            pw[0] = 1
            cur = 1
            for k in range(1, N):
                cur = cur * omega % p
                pw[k] = cur
            return pw
        from ..fields._tables import np_multiply

        if q <= 2**20:
            pw = np.empty(N, dtype=object)
            cur = 1
            for k in range(N):
                pw[k] = cur
                cur = int(np_multiply(self.meta, np.array([cur]), np.array([omega]))[0])
            return pw
        pw = np.empty(N, dtype=object)
        cur = 1
        for k in range(N):
            pw[k] = cur
            cur = hf.multiply(cur, omega)
        return pw

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        # NumPy (not jnp): plans are cached across traces; jnp constants
        # created under jit would leak tracers.
        from ..fields._array import _ints_to_storage_np

        vals = self.pw[idx]
        return _ints_to_storage_np(self.meta, np.asarray(vals, dtype=object))

    def _dft_matrix(self, n: int, stride: int) -> jnp.ndarray:
        s = np.arange(n).reshape(-1, 1)
        j = np.arange(n).reshape(1, -1)
        idx = (s * j * stride) % self.N
        return self._gather(idx)

    # ------------------------------------------------------------------
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """Transform the trailing axis (internal-storage array)."""
        return _fft_jit(self)(x)

    def device_tables(self):
        """Twiddle/DFT tables as device arrays, built once per plan.

        Passed to `transform` as runtime arguments by `_fft_jit`: embedding
        multi-hundred-MB tables as trace constants crashes the remote
        compile helper at large N and bloats every executable."""
        if not _trace_state_clean():
            # First call under an outer trace would cache TRACERS in this
            # cross-trace plan object; serve trace-local constants instead.
            return (
                tuple((jnp.asarray(tw), jnp.asarray(W)) for (_, _, tw, W) in self.levels),
                jnp.asarray(self.base_W),
            )
        if getattr(self, "_dev_tables", None) is None:
            self._dev_tables = (
                tuple((jax.device_put(tw), jax.device_put(W)) for (_, _, tw, W) in self.levels),
                jax.device_put(self.base_W),
            )
        return self._dev_tables

    def transform(self, x: jnp.ndarray, tables=None) -> jnp.ndarray:
        ops = self.ops
        storage_nd = _trailing_nd(self.meta)
        lev_tabs, base_W = tables if tables is not None else (None, jnp.asarray(self.base_W))

        def rec(x, level: int):
            # x: (..., size [, w])
            size = x.shape[-1 - storage_nd]
            if level == len(self.levels):
                return self._apply_dft(x, base_W)
            r, M, twiddle, W = self.levels[level]
            if lev_tabs is not None:
                twiddle, W = lev_tabs[level]
            # x[n], n = r*m + j  ->  (..., M, r)
            batch = x.shape[: x.ndim - 1 - storage_nd]
            tail = x.shape[x.ndim - storage_nd :]
            xr = x.reshape(batch + (M, r) + tail)
            xr = jnp.moveaxis(xr, -1 - storage_nd, -2 - storage_nd)  # (..., r, M)
            y = rec(xr, level + 1)                                    # (..., r, M)
            y = jnp.moveaxis(y, -2 - storage_nd, -1 - storage_nd)     # (..., M, r)
            z = ops.multiply(y, jnp.asarray(twiddle))
            # combine: X[s*M + k] = sum_j z[k, j] * W[s, j]
            out = self._contract(z, W)                                # (..., s, k) -> (..., M, r)?
            return out

        return rec(x, 0)

    # Cap on materialized product elements (times storage width) in the
    # contraction below; bigger workloads loop over j-chunks. 2^27 keeps the
    # intermediate under ~1 GB for 4-limb fields.
    _CONTRACT_BUDGET = 2**27

    def _apply_dft(self, x, W):
        """x: (..., n [, w]); W: (n, n [, w]). Returns X[s] = sum_j W[s,j] x[j]."""
        ops = self.ops
        storage_nd = _trailing_nd(self.meta)
        # NOTE: a modular-matmul formulation of this contraction sends XLA's
        # algebraic simplifier into a pathological (hours-long) loop at large
        # N; the elementwise+tree-reduce form compiles fast.
        n = x.shape[-1 - storage_nd]
        numel = int(np.prod(x.shape)) * n
        chunk = n
        while chunk > 1 and numel // n * chunk > self._CONTRACT_BUDGET:
            chunk //= 2
        Wd = jnp.asarray(W)
        out = None
        for j0 in range(0, n, chunk):
            xc = jax.lax.slice_in_dim(x, j0, j0 + chunk, axis=x.ndim - 1 - storage_nd)
            Wc = jax.lax.slice_in_dim(Wd, j0, j0 + chunk, axis=Wd.ndim - 1 - storage_nd)
            xj = jnp.expand_dims(xc, -2 - storage_nd)        # (..., 1, c)
            prod = ops.multiply(xj, Wc)                      # (..., n_s, c)
            part = _field_sum(ops, prod, axis=-1 - storage_nd)
            out = part if out is None else ops.add(out, part)
        return out

    def _contract(self, z, W):
        """z: (..., M, r); W: (r, r). X[s*M + k] = sum_j z[k,j] W[s,j];
        output flattened to (..., r*M) with s major."""
        ops = self.ops
        storage_nd = _trailing_nd(self.meta)
        r = z.shape[-1 - storage_nd]
        numel = int(np.prod(z.shape)) * r
        chunk = r
        while chunk > 1 and numel // r * chunk > self._CONTRACT_BUDGET:
            chunk //= 2
        Wd = jnp.asarray(W)
        out = None
        for j0 in range(0, r, chunk):
            zc = jax.lax.slice_in_dim(z, j0, j0 + chunk, axis=z.ndim - 1 - storage_nd)
            Wc = jax.lax.slice_in_dim(Wd, j0, j0 + chunk, axis=Wd.ndim - 1 - storage_nd)
            zj = jnp.expand_dims(zc, -3 - storage_nd)          # (..., 1, M=k, c)
            Wj = jnp.expand_dims(Wc, -2 - storage_nd)          # (r=s, 1, c)
            prod = ops.multiply(zj, Wj)                        # (..., s, k, c)
            part = _field_sum(ops, prod, axis=-1 - storage_nd)  # (..., s, k)
            out = part if out is None else ops.add(out, part)
        batch = out.shape[: out.ndim - 2 - storage_nd]
        tail = out.shape[out.ndim - storage_nd :]
        return out.reshape(
            batch + (out.shape[-2 - storage_nd] * out.shape[-1 - storage_nd],) + tail
        )


def _field_sum(ops, x, axis: int):
    """Reduce with field addition along `axis` via a binary tree (log depth)."""
    meta = ops.meta
    storage_nd = _trailing_nd(meta)
    if axis < 0:
        axis = x.ndim + axis
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        a = jax.lax.slice_in_dim(x, 0, half, axis=axis)
        b = jax.lax.slice_in_dim(x, half, 2 * half, axis=axis)
        rem = jax.lax.slice_in_dim(x, 2 * half, n, axis=axis)
        x = jnp.concatenate([ops.add(a, b), rem], axis=axis)
        n = half + (n - 2 * half)
    return jnp.squeeze(x, axis=axis)


def _matmul_split(N: int):
    """Divisor N1 of N closest to sqrt(N) with N1 and N/N1 both <= 4096
    (bounds the DFT-matrix constants at 64 MB of u32); None if no such
    split exists or N is too small to benefit."""
    if N <= _MAX_BASE:
        return None
    best = None
    d = 1
    while d * d <= N:
        if N % d == 0:
            for n1 in (d, N // d):
                n2 = N // n1
                if n1 <= 4096 and n2 <= 4096 and n1 > 1 and n2 > 1:
                    score = abs(n1 * n1 - N)
                    if best is None or score < best[0]:
                        best = (score, n1)
        d += 1
    return None if best is None else best[1]


# A DFT factor above this size is itself expanded as a recursive 6-step
# plan instead of a direct (K, K) matmul. Factors up to 4096 stay direct
# (large matmuls, fewer passes), and recursion only serves sizes a
# two-factor <= 4096 split cannot reach (N > 2^24).
_RECURSE_ABOVE = 4096


def _balanced_split(K: int):
    """Largest divisor of K that is <= sqrt(K); None if K is prime."""
    best = None
    d = 2
    while d * d <= K:
        if K % d == 0:
            best = d
        d += 1
    return best


def _largest_divisor_le(K: int, cap: int):
    """Largest divisor of K that is <= cap; None if only 1 qualifies."""
    best = None
    d = 1
    while d * d <= K:
        if K % d == 0:
            for c in (d, K // d):
                if 1 < c <= cap and (best is None or c > best):
                    best = c
        d += 1
    return best


class MatmulFFTPlan(FFTPlan):
    """Single-device 4-step NTT on int8 matmuls for prime fields.

    X[k1 + N1*k2] = sum_{n2} W2[n2,k2] * ( T[k1,n2] * sum_{n1} W1[k1,n1] *
    M[n1,n2] ) with M[n1,n2] = x[n1*N2 + n2]: two modular matmuls (int8
    plane path, ops/_linalg.py) around one elementwise twiddle. Replaces
    the elementwise mixed-radix recursion (which does no matmul) whenever
    N splits into factors <= 4096. The distributed analogue is
    parallel/_ntt_sharded.py; the reference's staged-loop kernel is
    src/galois/_domains/_function.py:170-384.
    """

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, n1: int):
        self.meta = meta
        self.N = N
        self.mode = mode
        self.ops = get_ops(meta, mode)
        from ..fields._hostfield import get_host_field

        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        self.n1 = n1
        self.n2 = N // n1
        # Factored-table mode (planar limb storage): the direct W1/T/W2
        # tables at N = 2^24 for a 16-limb field are three (16, 4096, 4096)
        # arrays — ~1.6 GB of host build and host-to-device copy. The
        # Vandermonde structure factors every table through <= 4096-length
        # power ladders: W1[k,j] = (w^n2)^(kj mod n1), W2[i,k] =
        # (w^n1)^(ik mod n2), and T[k,j] = w^(kj) = (w^n2)^q * w^r with
        # kj = q*n2 + r — so the plan ships three ~(w, 4096)-u16 ladders
        # (a few hundred KB) and a one-shot jitted builder gathers and
        # multiplies the full tables ON DEVICE (device_tables).
        self.factored = meta.storage == "limbs"
        if self.factored and N >= 2**31:
            # _factored_tables builds k1*k2 outer products with int32 iota;
            # kj < N must fit int32 or the gathers silently wrap.
            raise ValueError(
                f"Factored-table NTT plans require N < 2^31, got N = {N}."
            )
        if not self.factored:
            self.pw = self._build_power_table(hf, omega_int, N)
        # Each side is either a direct DFT matmul (factor <= _RECURSE_ABOVE)
        # or its own recursive 6-step sub-plan over omega^(N/factor).
        self.sub1 = self.sub2 = None
        self.W1 = self.W2 = None
        s1 = _balanced_split(n1) if n1 > _RECURSE_ABOVE else None
        if s1 is not None:
            self.sub1 = MatmulFFTPlan(meta, n1, hf.power(omega_int, self.n2), mode, s1)
        elif not self.factored:
            k1 = np.arange(n1).reshape(-1, 1)
            j1 = np.arange(n1).reshape(1, -1)
            self.W1 = self._gather((self.n2 * k1 * j1) % N)  # (N1, N1)
        s2 = _balanced_split(self.n2) if self.n2 > _RECURSE_ABOVE else None
        if s2 is not None:
            self.sub2 = MatmulFFTPlan(meta, self.n2, hf.power(omega_int, n1), mode, s2)
        elif not self.factored:
            n2i = np.arange(self.n2).reshape(-1, 1)
            k2 = np.arange(self.n2).reshape(1, -1)
            self.W2 = self._gather((self.n1 * n2i * k2) % N)  # (N2, N2)
        if self.factored:
            # lad_hi doubles as the W1 ladder (omega^n2, length n1); lad_lo
            # is needed for T; lad_w2 only when the N2 side is direct.
            self.lad_hi = self._ladder_storage(hf, hf.power(omega_int, self.n2), n1)
            self.lad_lo = self._ladder_storage(hf, omega_int, self.n2)
            self.lad_w2 = (
                self._ladder_storage(hf, hf.power(omega_int, n1), self.n2)
                if self.sub2 is None
                else None
            )
        else:
            t_k1 = np.arange(n1).reshape(-1, 1)
            t_n2 = np.arange(self.n2).reshape(1, -1)
            self.T = self._gather((t_k1 * t_n2) % N)  # (N1, N2)

    def _ladder_storage(self, hf, g: int, n: int) -> np.ndarray:
        """Length-n power ladder of g as internal storage (NumPy, planar)."""
        from ..fields._array import _ints_to_storage_np

        pw = np.empty(n, dtype=object)
        cur = 1
        for k in range(n):
            pw[k] = cur
            cur = hf.multiply(cur, g)
        return _ints_to_storage_np(self.meta, pw)

    def _factored_tables(self, lad_hi, lad_lo, lad_w2):
        """(W1|None, T, W2|None) from device ladders — index gathers along
        the power axis (int32 iota; kj < N < 2^31, asserted at plan build).
        The T twiddle product is one field multiply."""
        k1 = jax.lax.iota(jnp.int32, self.n1)
        k2 = jax.lax.iota(jnp.int32, self.n2)
        W1 = None
        if self.sub1 is None:
            idx = (k1[:, None] * k1[None, :]) % self.n1
            W1 = jnp.take(lad_hi, idx, axis=-1)  # (w, n1, n1)
        W2 = None
        if self.sub2 is None:
            idx = (k2[:, None] * k2[None, :]) % self.n2
            W2 = jnp.take(lad_w2, idx, axis=-1)  # (w, n2, n2)
        kj = k1[:, None] * k2[None, :]  # (n1, n2), < N
        hi = jnp.take(lad_hi, kj // self.n2, axis=-1)
        lo = jnp.take(lad_lo, kj % self.n2, axis=-1)
        T = self.ops.multiply(hi, lo)  # (w, n1, n2)
        return W1, T, W2

    def _factored_build(self, eager: bool):
        """Assemble (t1, T, t2) in factored mode. eager=True (trace-clean):
        device_put the ladders and run the builder under one jit, producing
        cacheable device arrays; eager=False (under an outer trace): inline
        the builder so only trace-local values are produced."""
        put = jax.device_put if eager else jnp.asarray
        lads = (
            put(self.lad_hi),
            put(self.lad_lo),
            put(self.lad_w2) if self.lad_w2 is not None else None,
        )
        W1, T, W2 = self._factored_tables(*lads)
        if eager:
            W1, T, W2 = (
                o if o is None else jax.block_until_ready(o) for o in (W1, T, W2)
            )
        t1 = self.sub1._factored_build(eager) if self.sub1 is not None else W1
        t2 = self.sub2._factored_build(eager) if self.sub2 is not None else W2
        return (t1, T, t2)

    def _table_repr(self, W, to_dev: bool):
        """Direct DFT table in the form transform consumes: int-storage
        prime fields ship PRECOMPUTED balanced int8 planes (runtime then
        only extracts the data operand's planes); other storages ship the
        raw table."""
        put = jax.device_put if to_dev else jnp.asarray
        if self.meta.storage == "int" and self.meta.is_prime_field:
            from ._linalg import balanced_planes_np

            return {"pl": put(balanced_planes_np(W, self.meta.characteristic))}
        return put(W)

    def device_tables(self):
        if not _trace_state_clean():
            # First call under an outer trace would cache TRACERS in this
            # cross-trace plan object (the cached-object invariant); serve
            # uncached trace-local constants instead.
            return self._host_tables()
        if getattr(self, "_dev_tables", None) is None:
            if self.factored:
                self._dev_tables = self._factored_build(True)
                return self._dev_tables
            t1 = (
                self.sub1.device_tables()
                if self.sub1 is not None
                else self._table_repr(self.W1, True)
            )
            t2 = (
                self.sub2.device_tables()
                if self.sub2 is not None
                else self._table_repr(self.W2, True)
            )
            self._dev_tables = (t1, jax.device_put(self.T), t2)
        return self._dev_tables

    def _host_tables(self):
        if self.factored:
            return self._factored_build(False)
        t1 = self.sub1._host_tables() if self.sub1 is not None else self._table_repr(self.W1, False)
        t2 = self.sub2._host_tables() if self.sub2 is not None else self._table_repr(self.W2, False)
        return (t1, jnp.asarray(self.T), t2)

    def transform(self, x: jnp.ndarray, tables=None) -> jnp.ndarray:
        from ._linalg import _prime_matmul_planes

        t1, T, t2 = tables if tables is not None else self._host_tables()
        p = self.meta.characteristic
        if self.meta.storage != "int":
            # Planar limb storage (w leading, rides as a batch axis): same
            # 4-step, matmul work via the limb matmul (ops/_limb_matmul.py).
            from ._limb_matmul import limb_matmul

            batch = x.shape[:-1]  # includes the leading (w,)
            M = x.reshape(batch + (self.n1, self.n2))
            if self.sub1 is not None:
                Mt = jnp.swapaxes(M, -2, -1)  # (w, ..., n2, n1)
                A = jnp.swapaxes(self.sub1.transform(Mt, t1), -2, -1)
            else:
                A = limb_matmul(self.meta, t1, M)
            B = self.ops.multiply(A, T)
            if self.sub2 is not None:
                C = self.sub2.transform(B, t2)
            else:
                C = limb_matmul(self.meta,B, t2)
            X = jnp.swapaxes(C, -1, -2)  # (w, ..., k2, k1)
            return X.reshape(batch + (self.N,))
        batch = x.shape[:-1]
        M = x.reshape(batch + (self.n1, self.n2))
        # Direct sides are int8 plane dots against the precomputed table
        # planes (_table_repr); recursive sides run their own sub-plan.
        if self.sub1 is not None:
            Mt = jnp.swapaxes(M, -1, -2)  # (..., n2, n1)
            A = jnp.swapaxes(self.sub1.transform(Mt, t1), -1, -2)
        else:
            A = _prime_matmul_planes(None, M, p, self.n1, a_planes=t1["pl"])
        B = self.ops.multiply(A, T)
        if self.sub2 is not None:
            C = self.sub2.transform(B, t2)
        else:
            C = _prime_matmul_planes(B, None, p, self.n2, b_planes=t2["pl"])
        X = jnp.swapaxes(C, -1, -2)  # (..., k2, k1) -> flat index k1 + N1*k2
        return X.reshape(batch + (self.N,))


@functools.lru_cache(maxsize=64)  # bounded: see codes/_decoder.py::make_decoder
def _plan(meta: FieldMeta, N: int, omega_int: int, mode: str) -> FFTPlan:
    from ._limb_matmul import supports_any as _limb_supports

    if (
        meta.is_prime_field
        and meta.characteristic > 2
        and (meta.storage == "int" or _limb_supports(meta))
    ):
        n1 = _matmul_split(N)
        if n1 is None and N > _MAX_BASE:
            # N too large for a two-factor <= 4096 split: the recursive
            # 6-step handles any 4096-smooth N (every leaf DFT stays a
            # direct <= 4096 matmul). Keep the direct side as large as
            # possible (big matmuls use the matrix units best).
            from ..nt.factorization import factors as _nt_factors

            primes, _ = _nt_factors(N)
            if max(primes) <= 4096:
                n1 = _largest_divisor_le(N, 4096)
        if n1 is not None:
            return MatmulFFTPlan(meta, N, omega_int, mode, n1)
    return FFTPlan(meta, N, omega_int, mode)


@functools.lru_cache(maxsize=64)  # bounded: see codes/_decoder.py::make_decoder
def _fft_jit(plan: FFTPlan):
    jf = jax.jit(plan.transform)

    def run(x):
        # tables ride as runtime args, not trace constants (see
        # FFTPlan.device_tables).
        return jf(x, plan.device_tables())

    return run


def _get_omega(cls, N: int) -> int:
    from ..fields._hostfield import get_host_field

    meta = cls._meta
    q = meta.order
    if (q - 1) % N != 0:
        raise ValueError(
            f"The FFT size {N} must divide the multiplicative group order {q - 1} of {cls.name}."
        )
    hf = get_host_field(meta)
    return hf.power(meta.primitive_element_int, (q - 1) // N)


def fft_data(cls, data, N: int, inverse: bool = False, scale: bool = None):
    """scale default: False for forward, True for inverse (NumPy 'backward')."""
    meta = cls._meta
    mode = cls._mode if cls._mode != "python-calculate" else meta.default_ufunc_mode
    omega = _get_omega(cls, N)
    if scale is None:
        scale = inverse
    if inverse:
        from ..fields._hostfield import get_host_field

        omega = get_host_field(meta).reciprocal(omega)
    plan = _plan(meta, N, omega, mode)
    out = _fft_jit(plan)(data)
    if scale:
        from ..fields._hostfield import get_host_field

        hf = get_host_field(meta)
        # Scaling by 1/N: N acts as the N-fold sum of 1, i.e. the prime-
        # subfield element N mod p (NOT the integer representation N).
        n_inv = hf.reciprocal(N % meta.characteristic)
        out = scale_jit(meta, mode, n_inv)(out)
    return out


@functools.lru_cache(maxsize=64)  # bounded: see codes/_decoder.py::make_decoder
def scale_jit(meta: FieldMeta, mode: str, c: int):
    """Cached jitted ``a -> a * c`` for a field constant (the inverse
    transform's 1/N): a fresh ``jax.jit(lambda ...)`` per call would
    retrace and recompile on every call."""
    ops = get_ops(meta, mode)
    return jax.jit(lambda o: ops.multiply(o, ops.from_int_scalar(c)))


def ifft_data(cls, data, N: int):
    return fft_data(cls, data, N, inverse=True)


def field_fft(x, n=None, axis=-1, norm=None):
    """np.fft.fft replacement for FieldArrays
    (reference: src/galois/_domains/_function.py:170-384).

    norm follows NumPy: forward transform scales by 1/N only for
    norm="forward"."""
    cls = type(x)
    if axis != -1:
        raise ValueError("Argument 'axis' must be -1 (trailing axis).")
    if norm not in (None, "backward", "forward"):
        raise ValueError("Argument 'norm' must be None, 'backward', or 'forward'.")
    N = x.shape[-1] if n is None else int(n)
    x = _pad_or_trim(x, N)
    out = fft_data(cls, x._data, N, scale=(norm == "forward"))
    return cls._view(out, x._dtype)


def field_ifft(x, n=None, axis=-1, norm=None):
    """Inverse transform; scales by 1/N unless norm="forward"."""
    cls = type(x)
    if axis != -1:
        raise ValueError("Argument 'axis' must be -1 (trailing axis).")
    if norm not in (None, "backward", "forward"):
        raise ValueError("Argument 'norm' must be None, 'backward', or 'forward'.")
    N = x.shape[-1] if n is None else int(n)
    x = _pad_or_trim(x, N)
    out = fft_data(cls, x._data, N, inverse=True, scale=(norm != "forward"))
    return cls._view(out, x._dtype)


def _pad_or_trim(x, N: int):
    cls = type(x)
    cur = x.shape[-1]
    if cur == N:
        return x
    if cur > N:
        return x[..., :N]
    pad_shape = x.shape[:-1] + (N - cur,)
    pad = cls.Zeros(pad_shape)
    # The transform axis is the trailing element axis: last data axis for
    # int and planar limb storage, -2 above a trailing digit axis.
    data = jnp.concatenate(
        [x._data, pad._data], axis=-1 - _trailing_nd(cls._meta)
    )
    return cls._view(data, x._dtype)
