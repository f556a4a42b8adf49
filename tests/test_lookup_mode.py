"""jit-lookup (XLA table gathers) agrees with jit-calculate on every
element, at array sizes of 2^13 and more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import galois_tpu as gt
from galois_tpu.ops._kernels import get_ops

N = 1 << 13


@pytest.mark.parametrize("op", ["multiply", "divide", "reciprocal"])
@pytest.mark.parametrize("q", [2**8, 3**5, 5**3, 2**10])
def test_lookup_matches_calculate(q, op):
    meta = gt.GF(q)._meta
    rng = np.random.default_rng(q)
    a = jnp.asarray(rng.integers(0, q, N), meta.internal_dtype)
    b = jnp.asarray(rng.integers(1, q, N), meta.internal_dtype)  # nonzero divisors
    args = (b,) if op == "reciprocal" else (a, b)
    got = jax.jit(getattr(get_ops(meta, "jit-lookup"), op))(*args)
    want = jax.jit(getattr(get_ops(meta, "jit-calculate"), op))(*args)
    assert got.dtype == want.dtype
    assert np.array_equal(np.asarray(got), np.asarray(want))
