"""Mesh-sharded FEC decode: the batch (codeword) axis over devices.

Decoding is embarrassingly parallel across codewords — the reference's
per-codeword batch loop (src/galois/_codes/_bch.py:1347) maps to ONE
fixed-shape XLA program whose leading axis XLA partitions over the mesh.
This wrapper places the received batch with a NamedSharding and feeds the
raw jitted decoder directly (the convenience `code.decode` path round-trips
through host NumPy, which would gather the batch to one device).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codes._decoder import make_decoder

__all__ = ["sharded_decode"]


@functools.lru_cache(maxsize=64)  # bounded: see codes/_decoder.py::make_decoder
def _shardmapped(decoder, mesh: Mesh, axis: str, n_in: int):
    """Jitted shard_map of a batch decoder over `mesh[axis]`.

    Decoding is embarrassingly parallel on the batch axis, so the decoder
    runs PER SHARD with zero collectives. Letting GSPMD auto-partition the
    decoder's scans/gathers instead inserted reshards that measured 130x
    SLOWER than single-device on the 8-device CPU mesh
    (benchmarks/bench_scaling.py, round 3). Cached so repeated calls reuse
    one executable (a fresh jax.jit per call retraces every time)."""
    fn = jax.shard_map(
        decoder,
        mesh=mesh,
        in_specs=(P(axis, None),) * n_in,
        out_specs=(P(axis, None), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def _raw_decoder(code, ns: int, with_erasures: bool):
    """The jitted fixed-shape decoder for `code` at received length ns.

    Mirrors BCH/RS `_decode_codeword` construction (codes/_bch.py,
    codes/_rs.py); syndrome arithmetic runs in the extension field for BCH
    and in the symbol field for RS."""
    ext = getattr(code, "extension_field", None) or code.field
    mode = ext._mode if ext._mode != "python-calculate" else ext._meta.default_ufunc_mode
    return ext, make_decoder(
        ext._meta,
        mode,
        code.field.order,
        ns,
        code.n,
        code.d,
        code.c,
        int(code.alpha),
        with_erasures=with_erasures,
    )


def sharded_decode(
    code, received, mesh: Mesh, axis: str = "x", output: str = "codeword", erasures=None
):
    """Decode a (B, ns) batch with B sharded over `mesh[axis]`.

    Returns ``(decoded, n_errors)`` where ``decoded`` is a FieldArray of
    corrected codewords (``output="codeword"``) or, for systematic codes,
    the recovered messages (``output="message"``, a device-side slice that
    preserves the sharding). ``n_errors`` is -1 where correction failed,
    matching ``code.decode(..., errors=True)``. ``erasures`` is the same
    boolean (B, ns) mask ``code.decode`` takes; it is sharded alongside the
    received batch.
    """
    if output not in ("codeword", "message"):
        raise ValueError(f"Argument 'output' must be 'codeword' or 'message', not {output!r}.")
    field = code.field
    r = np.asarray(received, dtype=np.int64) if not hasattr(received, "_data") else None
    if r is not None:
        data = jnp.asarray(r)
    else:
        data = received._data.astype(jnp.int64)
    if data.ndim != 2:
        raise ValueError(f"Argument 'received' must be 2-D (batch, ns), not {data.ndim}-D.")
    ns = data.shape[-1]
    # same ns validation as code.decode (codes/_linear.py): full length for
    # non-systematic codes, [n-k+1, n] for shortened systematic ones
    min_ns = code.n - code.k + 1 if code.is_systematic else code.n
    if not (min_ns <= ns <= code.n):
        raise ValueError(
            f"Argument 'received' must have last dimension in [{min_ns}, {code.n}], not {ns}."
        )
    if r is not None and (r.min() < 0 or r.max() >= code.field.order):
        raise ValueError(
            f"Argument 'received' must contain symbols in [0, {code.field.order}), "
            f"found range [{r.min()}, {r.max()}]."
        )
    sharding = NamedSharding(mesh, P(axis, None))
    if code.d <= 1:
        # d = 1: no correction capability — decode is the identity
        out = jax.device_put(data.astype(field._meta.internal_dtype), sharding)
        n_errors = jnp.zeros(data.shape[0], dtype=jnp.int64)
    else:
        if erasures is not None:
            emask = np.asarray(erasures)
            if emask.dtype != bool or emask.shape != tuple(data.shape):
                raise ValueError(
                    "Argument 'erasures' must be a boolean mask with the received batch's shape."
                )
        ext, decoder = _raw_decoder(code, ns, with_erasures=erasures is not None)
        dev = jax.device_put(data.astype(ext._meta.internal_dtype), sharding)
        if erasures is None:
            out, n_errors = _shardmapped(decoder, mesh, axis, 1)(dev)
        else:
            edev = jax.device_put(jnp.asarray(emask), sharding)
            out, n_errors = _shardmapped(decoder, mesh, axis, 2)(dev, edev)
        out = (out.astype(jnp.int64) % field.order).astype(field._meta.internal_dtype)
    if output == "message":
        if not code.is_systematic:
            raise ValueError("output='message' requires a systematic code.")
        ks = code.k - (code.n - ns)  # shortened message length
        out = out[..., :ks]
    return field._view(out, None), n_errors
