"""Multi-device sharded NTT via shard_map + all-to-all.

Four-step decomposition of a size-N transform over a D-device mesh
(SURVEY §7 M6 / BASELINE config 5): N = N1 * N2 with the input viewed
column-major as v[n1, n2] = x[n2*N1 + n1]:

    X[k1*N2 + k2] = DFT_N1( twiddle(n1, k2) * DFT_N2(v[n1, :]) )

Each local DFT reuses the single-device mixed-radix plan (ops/_ntt.py); the
two global transposes are all_to_all collectives over the mesh axis.
Twiddles are a device-resident cached array (not a trace constant) so
large fields don't bloat the executable.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fields._meta import FieldMeta
from ..ops._kernels import get_ops
from ..ops._ntt import FFTPlan, _plan, scale_jit

__all__ = ["sharded_fft", "sharded_batched_fft", "ShardedFFTPlan"]


class ShardingUnsupportedError(ValueError):
    """N cannot be 4-step sharded over this mesh axis (need D^2 | N)."""


class ShardedFFTPlan:
    """Plan for a size-N field FFT sharded over `n_devices` devices."""

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, mesh: Mesh, axis: str):
        self.meta = meta
        self.N = N
        self.mesh = mesh
        self.axis = axis
        D = mesh.shape[axis]
        self.D = D
        self.ops = get_ops(meta, mode)

        # Choose N1 ~ sqrt(N) (balanced local DFT sizes) subject to
        # D | N1 and D | N2 (required for the two transposes).
        import math

        N1 = D
        target = int(math.isqrt(N))
        while (
            N1 * 2 <= target
            and N % (N1 * 2) == 0
            and (N // (N1 * 2)) % D == 0
        ):
            N1 *= 2
        N2 = N // N1
        if N1 % D or N2 % D:
            raise ShardingUnsupportedError(
                f"Cannot shard N={N} over {D} devices (need D^2 | N)."
            )
        self.N1, self.N2 = N1, N2

        from ..fields._hostfield import get_host_field

        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        # Local plans: row DFT of size N2 with root omega^N1; then size N1
        # with root omega^N2.
        self.plan2 = _plan(meta, N2, hf.power(omega_int, N1), mode)
        self.plan1 = _plan(meta, N1, hf.power(omega_int, N2), mode)

        # Twiddle table T[n1, k2] = omega^(n1*k2), built once on device from
        # row seeds (kept OUT of the executable).
        self._omega_int = omega_int
        self._twiddle = None
        self._jitted = None

    def _build_twiddle(self):
        if self._twiddle is not None:
            return self._twiddle
        from ..fields._array import _ints_to_storage_np
        from ..fields._hostfield import get_host_field

        hf = get_host_field(self.meta)
        N1, N2 = self.N1, self.N2
        # row seeds omega^n1 for n1 < N1 (host; N1 is at most ~N/D, but we
        # build the full table host-side only for moderate N; device geometric
        # fill for large N).
        if self.N <= 2**20:
            T = np.empty((N1, N2), dtype=object)
            for n1 in range(N1):
                w = hf.power(self._omega_int, n1)
                cur = 1
                for k2 in range(N2):
                    T[n1, k2] = cur
                    cur = hf.multiply(cur, w)
            tw = jnp.asarray(_ints_to_storage_np(self.meta, T))
        else:
            # Device fill: T[n1] = cumulative powers of omega^n1 via log-
            # doubling along k2.
            seeds = np.empty((N1,), dtype=object)
            for n1 in range(N1):
                seeds[n1] = hf.power(self._omega_int, n1)
            from ..fields._array import _ints_to_storage

            seed_dev = _ints_to_storage(self.meta, seeds)
            ops = self.ops

            digits = self.meta.storage == "digits"
            cat_ax = 1  # k2 axis position: axis 1 for int/digits, 2 for planar
            if self.meta.storage_first:
                cat_ax = 2

            @jax.jit
            def fill(seed):
                # T[:, 0] = 1; T[:, k] = seed^k — build by doubling blocks.
                # seed: (N1,) int / (N1, m) digits / (w, N1) planar limbs.
                one = ops.one_like(seed)
                cols = one[:, None, :] if digits else one[..., None]
                width = 1
                cur_pow = seed  # seed^(width)
                while width < N2:
                    takew = min(width, N2 - width)
                    if digits:
                        blk = ops.multiply(cols[:, :takew, :], cur_pow[:, None, :])
                    else:
                        blk = ops.multiply(cols[..., :takew], cur_pow[..., None])
                    cols = jnp.concatenate([cols, blk], axis=cat_ax)
                    cur_pow = ops.multiply(cur_pow, cur_pow)
                    width *= 2
                return cols

            tw = fill(seed_dev)
        self._twiddle = tw
        return tw

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """x: (N,) / (N, m) / planar (w, N) global array (sharded or not) ->
        transformed, ordered naturally, sharded over the mesh axis."""
        mesh, axis = self.mesh, self.axis
        meta = self.meta
        N1, N2, D = self.N1, self.N2, self.D
        tw = self._build_twiddle()
        ops = self.ops
        plan1, plan2 = self.plan1, self.plan2

        lead = 1 if meta.storage_first else 0  # planar limb axis leads
        head = x.shape[:lead]                  # (w,) or ()
        tail = x.shape[lead + 1 :]             # (m,) for digits, else ()

        def local_fn(xl, twl, tabs1, tabs2):
            # xl: ([w,] N/D [, m]) local contiguous chunk of x.
            # Global view: M[n2, n1] = x[n2*N1 + n1]; device holds N2/D rows.
            Ml = xl.reshape(head + (N2 // D, N1) + tail)
            # transpose 1: -> v rows n1 (N1/D, N2)
            vl = _transpose(Ml, D, axis, lead)
            # local row DFT size N2 (root omega^N1); tables ride as runtime
            # args (replicated), not trace constants — see FFTPlan.device_tables
            Al = plan2.transform(vl, tabs2)
            # twiddle: T rows for global n1 of this device
            Bl = ops.multiply(Al, twl)
            # transpose 2: -> rows k2 (N2/D, N1)
            Cl = _transpose(Bl, D, axis, lead)
            # local row DFT size N1 (root omega^N2)
            Xl = plan1.transform(Cl, tabs1)
            # Xl[k2_local, k1] = X[k1*N2 + k2]; global output natural order
            # means device d should hold X[d*N/D ... ] = rows k1 of the
            # (N1, N2) result matrix R[k1, k2] = X[k1*N2+k2].
            Rl = _transpose(Xl, D, axis, lead)  # rows k1: (N1/D, N2)
            return Rl.reshape(head + (N // D,) + tail)

        if meta.storage_first:
            spec_x = P(None, axis)
            spec_tw = P(None, axis, None)
        else:
            t_nd = 1 if meta.storage == "digits" else 0
            spec_x = P(axis, *([None] * t_nd))
            spec_tw = P(axis, None, *([None] * t_nd))
        N = self.N
        tabs1 = plan1.device_tables()
        tabs2 = plan2.device_tables()
        # Fully-replicated specs mirroring the table pytrees
        spec_t1 = jax.tree.map(lambda _: P(), tabs1)
        spec_t2 = jax.tree.map(lambda _: P(), tabs2)
        if self._jitted is None:
            self._jitted = jax.jit(
                jax.shard_map(
                    local_fn, mesh=mesh, in_specs=(spec_x, spec_tw, spec_t1, spec_t2),
                    out_specs=spec_x, check_vma=False,
                )
            )
        return self._jitted(x, tw, tabs1, tabs2)


def _transpose(Ml, D: int, axis: str, lead: int = 0):
    """Distributed transpose inside shard_map.

    Ml: local ([w,] R/D, C [, m]) rows of a global (R, C) matrix — `lead`
    leading batch axes (the planar limb axis) ride along untouched, as does
    a trailing digit axis; returns local ([w,] C/D, R [, m]) rows of the
    transposed matrix."""
    RD = Ml.shape[lead]
    C = Ml.shape[lead + 1]
    head = Ml.shape[:lead]
    tail = Ml.shape[lead + 2 :]
    # split columns into D blocks -> (D, [w,] R/D, C/D)
    blocks = Ml.reshape(head + (RD, D, C // D) + tail)
    blocks = jnp.moveaxis(blocks, lead + 1, 0)
    # all_to_all: send block e to device e; receive (D, ...) where index
    # j is the block from device j (= rows j*R/D..) of our column slab.
    recv = jax.lax.all_to_all(blocks, axis, split_axis=0, concat_axis=0, tiled=False)
    recv = jnp.moveaxis(recv, 0, lead)
    # assemble (R, C/D): concatenate over j along rows
    slab = recv.reshape(head + (D * RD, C // D) + tail)
    # transpose rows<->cols
    perm = (
        tuple(range(lead))
        + (lead + 1, lead)
        + tuple(range(lead + 2, slab.ndim))
    )
    return jnp.transpose(slab, perm)


# bounded: see codes/_decoder.py::make_decoder — each entry pins a compiled
# executable; unbounded growth exhausts vm.max_map_count
@functools.lru_cache(maxsize=32)
def _sharded_plan(meta, N, omega, mode, mesh, axis):
    return ShardedFFTPlan(meta, N, omega, mode, mesh, axis)


@functools.lru_cache(maxsize=32)
def _replicated_fallback_fn(meta, N, omega, mode, mesh, axis):
    """Graceful fallback when D^2 does not divide N (but D | N): all_gather
    the input, run the full single-device plan redundantly on every device,
    keep only the local output shard. Correct for any N the local plan
    supports; communication is one all_gather instead of two all_to_alls."""
    plan = _plan(meta, N, omega, mode)
    tabs = plan.device_tables()
    D = mesh.shape[axis]
    e_ax = 1 if meta.storage_first else 0  # element axis under a planar lead

    def local(xl, tabs):
        full = jax.lax.all_gather(xl, axis, axis=e_ax, tiled=True)
        X = plan.transform(full, tabs)
        i = jax.lax.axis_index(axis)
        return jax.lax.dynamic_slice_in_dim(X, i * (N // D), N // D, axis=e_ax)

    if meta.storage_first:
        spec_x = P(None, axis)
    else:
        spec_x = P(axis, *([None] * (1 if meta.storage == "digits" else 0)))
    spec_t = jax.tree.map(lambda _: P(), tabs)
    fn = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(spec_x, spec_t), out_specs=spec_x, check_vma=False)
    )
    return lambda data: fn(data, tabs)


def sharded_batched_fft(field_cls, x, mesh: Mesh, axis: str = "x", inverse: bool = False):
    """Batched NTT with the BATCH axis sharded over the mesh: x is (B, N[,w])
    with B = D * b rows; every device transforms its own rows with the
    single-device mixed-radix plan — embarrassingly parallel, zero
    collectives (SURVEY §5 'parallelism & comms'; the reference's analogue
    is the prange batch loop, src/galois/_domains/_function.py:247-384)."""
    from ..fields._array import FieldArray
    from ..fields._hostfield import get_host_field
    from ..ops._ntt import _get_omega

    meta = field_cls._meta
    mode = field_cls._mode if field_cls._mode != "python-calculate" else meta.default_ufunc_mode
    data = x._data if isinstance(x, FieldArray) else x
    lead = 1 if meta.storage_first else 0
    if data.ndim < 2 + lead:
        raise ValueError("sharded_batched_fft expects a (batch, N) array.")
    B, N = data.shape[lead], data.shape[lead + 1]
    D = mesh.shape[axis]
    if B % D:
        raise ValueError(f"Batch {B} must be divisible by the mesh axis size {D}.")
    omega = _get_omega(field_cls, N)
    hf = get_host_field(meta)
    if inverse:
        omega = hf.reciprocal(omega)
    plan = _plan(meta, N, omega, mode)
    tabs = plan.device_tables()

    if inverse:
        n_inv = hf.reciprocal(N % meta.characteristic)

    def local(xl, tabs):
        out = plan.transform(xl, tabs)
        if inverse:
            ops = get_ops(meta, mode)
            out = ops.multiply(out, ops.from_int_scalar(n_inv))
        return out

    if meta.storage_first:
        spec_x = P(None, axis, None)
    else:
        spec_x = P(axis, None, *([None] * (1 if meta.storage == "digits" else 0)))
    spec_t = jax.tree.map(lambda _: P(), tabs)
    fn = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(spec_x, spec_t), out_specs=spec_x, check_vma=False)
    )
    out = fn(data, tabs)
    if isinstance(x, FieldArray):
        return field_cls._view(out, x._dtype)
    return out


def sharded_fft(field_cls, x, mesh: Mesh, axis: str = "x", inverse: bool = False):
    """Transform a 1-D FieldArray (or storage array) of size N over the mesh.

    Uses the all-to-all 4-step plan when D^2 | N; falls back to the
    replicated all_gather path when only D | N."""
    from ..fields._array import FieldArray
    from ..fields._hostfield import get_host_field
    from ..ops._ntt import _get_omega

    meta = field_cls._meta
    mode = field_cls._mode if field_cls._mode != "python-calculate" else meta.default_ufunc_mode
    data = x._data if isinstance(x, FieldArray) else x
    N = data.shape[1 if meta.storage_first else 0]
    omega = _get_omega(field_cls, N)
    hf = get_host_field(meta)
    if inverse:
        omega = hf.reciprocal(omega)
    D = mesh.shape[axis]
    if N % D:
        raise ValueError(f"N={N} must at least be divisible by the mesh axis size {D}.")
    try:
        plan = _sharded_plan(meta, N, omega, mode, mesh, axis)
    except ShardingUnsupportedError:
        # Loud by design: the replicated path is correct but gives ZERO
        # speedup (every device runs the full transform). Real ValueErrors
        # from the sharded execution propagate — only the D^2 divisibility
        # rejection routes here.
        import warnings

        warnings.warn(
            f"sharded_fft: N={N} is not 4-step shardable over {D} devices "
            f"(need D^2 | N); falling back to a REPLICATED transform with no "
            f"speedup. Pick N with D^2 | N to scale.",
            RuntimeWarning,
            stacklevel=2,
        )
        out = _replicated_fallback_fn(meta, N, omega, mode, mesh, axis)(data)
    else:
        out = plan(data)
    if inverse:
        out = scale_jit(meta, mode, hf.reciprocal(N % meta.characteristic))(out)
    if isinstance(x, FieldArray):
        return field_cls._view(out, x._dtype)
    return out
