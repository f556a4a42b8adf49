"""GF(2^m) matrix multiply via bit-plane decomposition.

A GF(2^m) matmul C = A @ B decomposes into m^2 boolean matmuls: writing
elements as bit vectors, product-polynomial coefficient k is

    P_k = XOR-sum over n of AND(A_i, B_j) for i + j = k
        = parity( sum_n A_i[., n] * B_j[n, .] )

so each (i, j) pair is one int8 matmul of 0/1 matrices with int32 sums
(exact while the contraction sum stays below 2^31), and the 2m-1 product bits fold back to m
bits through the irreducible polynomial's reduction matrix mod 2.

This is the dense-matmul answer to the reference's prange triple-loop extension
field matmul (reference: src/galois/_domains/_linalg.py:280-308, 5.5x slower
than BLAS) — here the work IS BLAS-shaped.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import FieldMeta
from ._linalg import int8_matmul

__all__ = ["binary_matmul", "supports"]


def supports(meta: FieldMeta, K: int) -> bool:
    return (
        meta.characteristic == 2
        and 1 < meta.degree <= 32
        and meta.storage == "int"
        and K < 2**24  # block sums far inside int32
    )


@functools.lru_cache(maxsize=None)
def _reduction_rows(meta: FieldMeta):
    """(m-1, m) 0/1 matrix: product bit m+k folds into these output bits."""
    m = meta.degree
    f = meta.irreducible_poly_int
    rows = []
    for k in range(m - 1):
        # x^(m+k) mod f as bits
        v = 1 << (m + k)
        for i in range(2 * m - 2, m - 1, -1):
            if (v >> i) & 1:
                v ^= f << (i - m)
        rows.append([(v >> j) & 1 for j in range(m)])
    return np.array(rows, dtype=np.int64)


def binary_matmul(meta: FieldMeta, a, b):
    """a: (..., M, K), b: (..., K, N) uint arrays of GF(2^m) int reprs.

    All m^2 plane products come from ONE stacked int8 matmul:
    (m*M, K) @ (K, m*N) — block (i, j) is A_i @ B_j."""
    m = meta.degree
    M, K = a.shape[-2], a.shape[-1]
    N = b.shape[-1]
    a32 = a.astype(jnp.int32)
    b32 = b.astype(jnp.int32)
    # int8 0/1 planes with int32 accumulation: exact for K < 2^31.
    astack = jnp.concatenate(
        [((a32 >> i) & 1).astype(jnp.int8) for i in range(m)], axis=-2
    )  # (..., m*M, K)
    bstack = jnp.concatenate(
        [((b32 >> j) & 1).astype(jnp.int8) for j in range(m)], axis=-1
    )  # (..., K, m*N)
    big = int8_matmul(astack, bstack)
    big = big & 1  # parity of each A_i @ B_j block

    def block(i, j):
        return big[..., i * M : (i + 1) * M, j * N : (j + 1) * N]

    prod_bits = []
    for k in range(2 * m - 1):
        acc = None
        for i in range(max(0, k - m + 1), min(m, k + 1)):
            t = block(i, k - i)
            acc = t if acc is None else acc ^ t
        prod_bits.append(acc)

    R = _reduction_rows(meta)
    out = jnp.zeros_like(prod_bits[0])
    for jbit in range(m):
        bit = prod_bits[jbit]
        for k in range(m - 1):
            if R[k, jbit]:
                bit = bit ^ prod_bits[m + k]
        out = out | (bit << jbit)
    return out.astype(a.dtype)
