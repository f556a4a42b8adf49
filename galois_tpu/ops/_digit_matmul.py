"""GF(p^m) (p odd) matrix multiply via digit-plane decomposition.

Elements are base-p digit vectors; the product's digit-convolution
coefficient k is sum over n of A_i[., n] * B_j[n, .] for i + j = k — so one
stacked (m*M, K) @ (K, m*N) f32 matmul yields every digit-pair block, exact
while K * (p-1)^2 < 2^24. Blocks fold mod p through the field's reduction
matrix. The odd-extension sibling of ops/_binary_matmul.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._meta import FieldMeta

__all__ = ["digit_matmul", "supports"]


def supports(meta: FieldMeta, K: int) -> bool:
    p = meta.characteristic
    return (
        p > 2
        and meta.degree > 1
        and meta.storage == "int"
        and K * (p - 1) ** 2 < 2**24  # exact f32 accumulation
    )


def digit_matmul(meta: FieldMeta, a, b):
    """a: (..., M, K), b: (..., K, N) int reprs of GF(p^m) (int storage)."""
    p, m = meta.characteristic, meta.degree
    M, K = a.shape[-2], a.shape[-1]
    N = b.shape[-1]
    a32 = a.astype(jnp.int32)
    b32 = b.astype(jnp.int32)

    def digit(x, i):
        for _ in range(i):
            x = x // p
        return (x % p).astype(jnp.float32)

    astack = jnp.concatenate([digit(a32, i) for i in range(m)], axis=-2)
    bstack = jnp.concatenate([digit(b32, j) for j in range(m)], axis=-1)
    # HIGHEST: TF32 holds integers exactly only below 2^11, digits reach 4095
    big = jnp.matmul(
        astack, bstack, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    big = big.astype(jnp.int32) % p

    def block(i, j):
        return big[..., i * M : (i + 1) * M, j * N : (j + 1) * N]

    conv = []
    for k in range(2 * m - 1):
        acc = None
        for i in range(max(0, k - m + 1), min(m, k + 1)):
            t = block(i, k - i)
            acc = t if acc is None else acc + t
        conv.append(acc % p)

    # reduce: out_digits[j] = conv[j] + sum_k R[k, j] * conv[m + k] (mod p)
    R = np.asarray(meta.reduction_matrix)  # (m-1, m)
    out = jnp.zeros_like(conv[0])
    weight = 1
    for j in range(m):
        dig = conv[j]
        for k in range(m - 1):
            r = int(R[k, j])
            if r:
                dig = dig + r * conv[m + k]
        dig = dig % p
        out = out + dig * weight
        weight *= p
    return out.astype(a.dtype)
