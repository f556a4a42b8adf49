"""Smoke test of galois_tpu on an NVIDIA GPU.

Drives the library's hot paths once through the public API, at the sizes
its users run, and checks every result exactly against an independent
host reference (NumPy modular arithmetic, exact Python ints, or the
host-exact field in ``fields/_hostfield.py``):

  0. device: the JAX platform must be ``gpu``; prints the card's name
     and power limit from ``nvidia-smi``.
  1. fields: elementwise ``*``, ``+``, ``np.reciprocal``, ``**`` over
     GF(2^8), GF(2^31-1), GF(3*2^30+1), Goldilocks and GF(3^5).
  2. linear algebra: ``@`` and ``np.linalg.inv``.
  3. NTT: ``np.fft.fft`` / ``np.fft.ifft`` and ``gt.ntt`` / ``gt.intt``.
  4. FEC: ``ReedSolomon`` and ``BCH`` ``encode`` / ``decode``.

With ``--four-cards`` it runs only the mesh path of ``galois_tpu.parallel``
over four cards, each result compared bit for bit with the single-card
result of the same process.

Every phase prints one line per workload: its cold time (compile plus
first run), warm time (second run, ended by ``block_until_ready``), the
process's ``peak_bytes_in_use`` so far, and the result of its exact
comparison. Any mismatch or error exits non-zero. The last line of
standard output is one JSON object naming the device.

Before phase 1, the library's int8 dot is checked at every contraction
size from 1 to 64 and at larger ones. ``--probe PART ...`` runs only the
kernel-decision measurements of ``benchmarks/kernel_probe.py``.

Usage: ``python chip_smoke.py [--four-cards | --probe PART ...]`` from the
repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

P_M31 = 2**31 - 1
P_NTT = 3 * 2**30 + 1
P_GOLD = 2**64 - 2**32 + 1
P_BLS = 52435875175126190479447740508185965837690552500527637822603658699938581184513


# ----------------------------------------------------------------------
# Device and compile cache
# ----------------------------------------------------------------------

def compile_cache_dir(environ=os.environ) -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set, else the fixed ``.jax_cache`` in the checkout (a fixed path,
    so a later run finds what an earlier one compiled)."""
    return environ.get(CACHE_ENV) or str(ROOT / ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX at `compile_cache_dir`. JAX reads the variable itself, so
    when it is set no other cache is configured here."""
    import jax

    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return jax.config.jax_compilation_cache_dir


def require_gpu(n_cards: int = 1):
    """The GPU devices, or SystemExit when JAX finds fewer than n_cards."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: JAX found no GPU ({e})")
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r}); "
            "this script needs an NVIDIA GPU and never falls back to the CPU."
        )
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devices)}.")
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi`` in a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ----------------------------------------------------------------------
# Timing, reporting, data
# ----------------------------------------------------------------------

def timed(fn, *args):
    """(result, cold seconds, warm seconds). Cold is the first call,
    compilation included; warm is the second. Both end in
    ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, cold, time.perf_counter() - t0


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, name: str, cold: float, warm: float, ok: bool, **extra) -> None:
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    print(
        f"[{phase}] {name}: cold_s={cold:.6f} warm_s={warm:.6f} "
        f"peak_bytes_in_use={peak_bytes()} exact={'PASS' if ok else 'FAIL'} {fields}".rstrip(),
        flush=True,
    )
    if not ok:
        raise AssertionError(f"[{phase}] {name}: result differs from the reference")


def rand_u32(seed: int, shape):
    import jax

    return jax.random.bits(jax.random.key(seed), shape, "uint32")


def rand_limbs(seed: int, width: int, n: int, top_mask: int):
    """(width, n) planar u16 limbs of values below the field order: the top
    limb is capped by ``top_mask``."""
    import jax.numpy as jnp

    limbs = (rand_u32(seed, (width, n)) & 0xFFFF).astype(jnp.uint16)
    return limbs.at[width - 1].set(jnp.minimum(limbs[width - 1], jnp.uint16(top_mask)))


def limbs_to_objects(limbs) -> "np.ndarray":
    """(w, ...) planar u16 limbs -> object array of exact Python ints."""
    import numpy as np

    limbs = np.asarray(limbs).astype(np.uint64)
    words = [
        limbs[i] | (limbs[i + 1] << 16) | (limbs[i + 2] << 32) | (limbs[i + 3] << 48)
        for i in range(0, limbs.shape[0], 4)
    ]
    out = words[-1].astype(object)
    for w in reversed(words[:-1]):
        out = out * (1 << 64) + w.astype(object)
    return out


def host_table(field, op) -> "np.ndarray":
    """Full op table of a small field from the host-exact field."""
    import numpy as np

    from galois_tpu.fields._hostfield import get_host_field

    hf = get_host_field(field._meta)
    q = field.order
    return np.array([[getattr(hf, op)(a, b) for b in range(q)] for a in range(q)], dtype=np.int64)


# ----------------------------------------------------------------------
# int8 dots: the contraction sizes XLA's dot is trusted with
# ----------------------------------------------------------------------

DOT_KS = tuple(range(1, 65)) + (96, 127, 128, 255, 256, 511, 512, 1023, 2048)
# (batch, M, N): the smallest, the BCH Chien shape, a batched GF(2^8)
# product, and a decoder-sized one; batch 1 means plain 2-D operands
DOT_SHAPES = ((1, 64, 48), (1, 1152, 4599), (16, 128, 256), (1, 8192, 2040))


def dot_kind(hlo_text: str) -> str:
    """What XLA made of a compiled module's dot: a cuBLAS call, a Triton
    GEMM fusion, or neither (a plain fusion)."""
    if "__cublas" in hlo_text:
        return "cublas"
    if "triton" in hlo_text:
        return "triton"
    return "fusion"


def _dot_operands(rng, K: int, batch: int, M: int, N: int):
    lead = () if batch == 1 else (batch,)
    return (rng.integers(-128, 128, lead + (M, K), dtype="int8"),
            rng.integers(-128, 128, lead + (K, N), dtype="int8"))


def _dot_exact(a, b, got) -> bool:
    """got == a @ b, against a float64 host product (exact: every sum of
    int8 products over K <= 2048 is below 2^25)."""
    import numpy as np

    got = np.asarray(got)
    return got.dtype == np.int32 and np.array_equal(got, np.matmul(a.astype(np.float64), b.astype(np.float64)))


def int8_dot_sweep(dot, ks=DOT_KS, shapes=DOT_SHAPES, seed: int = 0):
    """Compile ``dot`` (int8 (..., M, K) x (..., K, N) -> int32) alone for
    every K and shape and check it. Returns the failures as
    (K, batch, M, N) and, per K, what each shape's dot compiled to."""
    import jax
    import numpy as np

    rng = np.random.default_rng(seed)
    jdot = jax.jit(dot)
    failures, kinds = [], {}
    for K in ks:
        kinds[K] = []
        for shape in shapes:
            a, b = _dot_operands(rng, K, *shape)
            da, db = jax.device_put(a), jax.device_put(b)
            compiled = jdot.lower(da, db).compile()
            if not _dot_exact(a, b, compiled(da, db)):
                failures.append((K,) + shape)
            kinds[K].append(dot_kind(compiled.as_text()))
    return failures, kinds


SMOKE_DOT_KS = tuple(range(1, 65)) + (96, 127, 128, 255, 256, 511, 512)


def phase_dots(ks=SMOKE_DOT_KS, shapes=DOT_SHAPES, seed: int = 0) -> None:
    """The library's int8 dot (``ops/_linalg.py::int8_matmul``) at every
    contraction size in ``ks``; each shape's dots compile as one module."""
    import jax
    import numpy as np

    from galois_tpu.ops._linalg import int8_matmul

    rng = np.random.default_rng(seed)
    sweep = jax.jit(lambda As, Bs: [int8_matmul(a, b) for a, b in zip(As, Bs)])
    failures, args, cold = [], [], 0.0
    for shape in shapes:
        host = [_dot_operands(rng, K, *shape) for K in ks]
        dev = jax.device_put(([a for a, _ in host], [b for _, b in host]))
        t0 = time.perf_counter()
        outs = jax.block_until_ready(sweep(*dev))
        cold += time.perf_counter() - t0
        failures += [(K,) + shape for K, (a, b), got in zip(ks, host, outs) if not _dot_exact(a, b, got)]
        args.append(dev)
    t0 = time.perf_counter()
    jax.block_until_ready([sweep(*dev) for dev in args])
    warm = time.perf_counter() - t0
    report("dots", f"int8_matmul K={ks[0]}..{ks[-1]} ({len(ks)} sizes x {len(shapes)} shapes)",
           cold, warm, not failures, failures=failures[:8])


# ----------------------------------------------------------------------
# Phase 1: fields
# ----------------------------------------------------------------------

def phase_fields(log_n: int = 26, log_n_wide: int = 24, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import galois_tpu as gt
    from galois_tpu.fields._hostfield import get_host_field

    n, nw = 1 << log_n, 1 << log_n_wide
    mul = jax.jit(lambda x, y: x * y)
    add = jax.jit(lambda x, y: x + y)
    recip = jax.jit(lambda x: np.reciprocal(x))
    pow7 = jax.jit(lambda x: x**7)

    # GF(2^8), u8 operands of 2^26 elements, against 256x256 tables
    GF = gt.GF(2**8)
    a = GF((rand_u32(seed, (n,)) % 255 + 1).astype(jnp.uint8))  # nonzero: reciprocal
    b = GF((rand_u32(seed + 1, (n,)) & 0xFF).astype(jnp.uint8))
    ah, bh = np.asarray(a.jax), np.asarray(b.jax)
    hf = get_host_field(GF._meta)
    mtab = host_table(GF, "multiply")
    size = f"2^{log_n}"
    c, cold, warm = timed(mul, a, b)
    report("fields", f"GF(2^8) multiply {size}", cold, warm, np.array_equal(np.asarray(c.jax), mtab[ah, bh]))
    c, cold, warm = timed(add, a, b)
    report("fields", f"GF(2^8) add {size}", cold, warm, np.array_equal(np.asarray(c.jax), ah ^ bh))
    rtab = np.array([0] + [hf.reciprocal(v) for v in range(1, 256)])
    c, cold, warm = timed(recip, a)
    report("fields", f"GF(2^8) reciprocal {size}", cold, warm, np.array_equal(np.asarray(c.jax), rtab[ah]))
    ptab = np.array([hf.power(v, 7) for v in range(256)])
    c, cold, warm = timed(pow7, a)
    report("fields", f"GF(2^8) power 7 {size}", cold, warm, np.array_equal(np.asarray(c.jax), ptab[ah]))
    GF.compile("jit-lookup")
    try:
        c, cold, warm = timed(jax.jit(lambda x, y: x * y), a, b)
    finally:
        GF.compile("jit-calculate")
    report("fields", f"GF(2^8) multiply jit-lookup {size}", cold, warm,
           np.array_equal(np.asarray(c.jax), mtab[ah, bh]))
    del a, b, c, ah, bh

    # 32-bit prime fields: uint64 products of operands below 2^32 are exact
    for p, label in ((P_M31, "GF(2^31-1)"), (P_NTT, "GF(3*2^30+1)")):
        F = gt.GF(p)
        x = F(rand_u32(seed + 2, (n,)) % p)
        y = F(rand_u32(seed + 3, (n,)) % p)
        xh, yh = np.asarray(x.jax).astype(np.uint64), np.asarray(y.jax).astype(np.uint64)
        z, cold, warm = timed(mul, x, y)
        report("fields", f"{label} multiply {size}", cold, warm,
               np.array_equal(np.asarray(z.jax).astype(np.uint64), xh * yh % np.uint64(p)))
        del x, y, z, xh, yh

    # Goldilocks at 2^24 (planar u16 limbs): exact Python ints on a sample
    G = gt.GF(P_GOLD)
    x = G(rand_limbs(seed + 4, 4, nw, 0xFFFE))
    y = G(rand_limbs(seed + 5, 4, nw, 0xFFFE))
    z, cold, warm = timed(mul, x, y)
    idx = np.random.default_rng(seed).choice(nw, min(nw, 1 << 16), replace=False)
    xs, ys, zs = (limbs_to_objects(np.asarray(v.jax)[:, idx]) for v in (x, y, z))
    ok = all(int(zz) == int(xx) * int(yy) % P_GOLD for xx, yy, zz in zip(xs, ys, zs))
    report("fields", f"Goldilocks multiply 2^{log_n_wide}", cold, warm, ok, sampled=len(idx))
    del x, y, z

    # GF(3^5) at 2^24 (odd-extension digits), calculate and lookup modes
    F3 = gt.GF(3**5)
    x = F3((rand_u32(seed + 6, (nw,)) % 243).astype(jnp.uint8))
    y = F3((rand_u32(seed + 7, (nw,)) % 243).astype(jnp.uint8))
    tab3 = host_table(F3, "multiply")
    want = tab3[np.asarray(x.jax), np.asarray(y.jax)]
    for mode in ("jit-calculate", "jit-lookup"):
        F3.compile(mode)
        try:
            z, cold, warm = timed(jax.jit(lambda u, v: u * v), x, y)
        finally:
            F3.compile("jit-calculate")
        report("fields", f"GF(3^5) multiply {mode} 2^{log_n_wide}", cold, warm,
               np.array_equal(np.asarray(z.jax), want))


# ----------------------------------------------------------------------
# Phase 2: linear algebra
# ----------------------------------------------------------------------

def _sampled_products_ok(A, B, C, add, mul, samples, rng) -> bool:
    """C[..., i, j] == sum_k A[..., i, k] * B[..., k, j] on sampled entries,
    in exact host arithmetic."""
    import numpy as np

    A, B, C = (np.asarray(v) for v in (A, B, C))
    for _ in range(samples):
        bi = tuple(int(rng.integers(0, s)) for s in A.shape[:-2])
        i, j = int(rng.integers(0, A.shape[-2])), int(rng.integers(0, B.shape[-1]))
        acc = 0
        for a, b in zip(A[bi + (i,)].tolist(), B[bi + (slice(None), j)].tolist()):
            acc = add(acc, mul(a, b))
        if acc != int(C[bi + (i, j)]):
            return False
    return True


def phase_linalg(n8: int = 256, batch8: int = 512, n31: int = 1024, n_inv: int = 256, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import galois_tpu as gt
    from galois_tpu.fields._hostfield import get_host_field

    rng = np.random.default_rng(seed)
    matmul = jax.jit(lambda x, y: x @ y)

    GF = gt.GF(2**8)
    hf = get_host_field(GF._meta)
    A = GF((rand_u32(seed, (n8, n8)) & 0xFF).astype(jnp.uint8))
    B = GF((rand_u32(seed + 1, (n8, n8)) & 0xFF).astype(jnp.uint8))
    C, cold, warm = timed(matmul, A, B)
    ok = _sampled_products_ok(A.jax, B.jax, C.jax, hf.add, hf.multiply, 64, rng)
    report("linalg", f"GF(2^8) matmul {n8}x{n8}", cold, warm, ok, sampled=64)
    A = GF((rand_u32(seed + 2, (batch8, n8, n8)) & 0xFF).astype(jnp.uint8))
    B = GF((rand_u32(seed + 3, (batch8, n8, n8)) & 0xFF).astype(jnp.uint8))
    C, cold, warm = timed(matmul, A, B)
    ok = _sampled_products_ok(A.jax, B.jax, C.jax, hf.add, hf.multiply, 64, rng)
    report("linalg", f"GF(2^8) batched matmul {batch8}x{n8}x{n8}", cold, warm, ok, sampled=64)

    F = gt.GF(P_M31)
    A = F(rand_u32(seed + 4, (n31, n31)) % P_M31)
    B = F(rand_u32(seed + 5, (n31, n31)) % P_M31)
    C, cold, warm = timed(matmul, A, B)
    ok = _sampled_products_ok(
        A.jax, B.jax, C.jax, lambda u, v: (u + v) % P_M31, lambda u, v: u * v % P_M31, 64, rng
    )
    report("linalg", f"GF(2^31-1) matmul {n31}x{n31}", cold, warm, ok, sampled=64)

    A = F(rand_u32(seed + 6, (n_inv, n_inv)) % P_M31)  # singular with prob ~n/p
    Ainv, cold, warm = timed(np.linalg.inv, A)
    ok = np.array_equal(np.asarray((A @ Ainv).jax), np.eye(n_inv, dtype=np.int64))
    report("linalg", f"GF(2^31-1) inv {n_inv}x{n_inv} (A @ inv(A) == I)", cold, warm, ok)


# ----------------------------------------------------------------------
# Phase 3: NTT
# ----------------------------------------------------------------------

def _power_table(g: int, n: int, p: int):
    """[g^0, ..., g^(n-1)] mod p: uint64 below 2^32, exact ints above."""
    import numpy as np

    small = p < 2**32
    pw = np.ones(1, dtype=np.uint64 if small else object)
    gk = g % p
    while len(pw) < n:
        nxt = pw * (np.uint64(gk) if small else gk) % (np.uint64(p) if small else p)
        pw = np.concatenate([pw, nxt])
        gk = gk * gk % p
    return pw[:n]


def _direct_dft_ok(x, X, p: int, ks) -> bool:
    """X[k] == sum_n x[n] w^(nk) (w = alpha^((p-1)/N), alpha the field's
    primitive element) at the indices ks, by O(N) direct evaluation."""
    import numpy as np

    import galois_tpu as gt

    N = len(x)
    w = pow(int(gt.GF(p).primitive_element), (p - 1) // N, p)
    pw = _power_table(w, N, p)
    n = np.arange(N, dtype=np.int64)
    for k, Xk in zip(ks, X):
        wk = pw[(n * int(k)) % N]
        if p < 2**32:  # terms < 2^64; the sum of N <= 2^31 residues fits too
            total = int((x * wk % np.uint64(p)).sum(dtype=np.uint64))
        else:  # exact Python ints
            total = int(np.dot(x, wk))
        if total % p != int(Xk):
            return False
    return True


def _ntt_case(label, F, x, n_check, seed, batch_rows) -> None:
    """Forward/inverse round trip plus direct evaluation of n_check outputs
    in each of ``batch_rows`` rows."""
    import jax.numpy as jnp
    import numpy as np

    p = F.characteristic
    N = x.shape[-1]
    X, cold, warm = timed(np.fft.fft, x)
    back, icold, iwarm = timed(np.fft.ifft, X)
    ok_rt = bool(jnp.array_equal(back.jax, x.jax))
    rng = np.random.default_rng(seed)
    ok_dft = True
    limbs = F._meta.storage_first
    for r in batch_rows:
        ks = np.sort(rng.choice(N, n_check, replace=False))
        if limbs:
            row = (lambda d: d[:, r] if d.ndim == 3 else d)
            xr = limbs_to_objects(row(x.jax))
            Xr = limbs_to_objects(np.asarray(row(X.jax))[:, ks])
        else:
            row = (lambda d: d[r] if d.ndim == 2 else d)
            xr = np.asarray(row(x.jax)).astype(np.uint64)
            Xr = np.asarray(row(X.jax))[ks].astype(np.int64)
        ok_dft &= _direct_dft_ok(xr, Xr, p, ks)
    report("ntt", f"{label} fft", cold, warm, ok_dft, direct_checked=n_check * len(batch_rows))
    report("ntt", f"{label} ifft (ifft(fft(x)) == x)", icold, iwarm, ok_rt)


def phase_ntt(cases=((20, 32), (24, 4)), log_gold: int = 24, bls_logs=(22, 24), seed: int = 0) -> None:
    import numpy as np

    import galois_tpu as gt

    Fp = gt.GF(P_NTT)
    for log_n, batch in cases:
        x = Fp(rand_u32(seed + log_n, (batch, 1 << log_n)) % P_NTT)
        _ntt_case(f"GF(3*2^30+1) 2^{log_n} batch {batch}", Fp, x, 8, seed, (0, batch - 1))
        del x

    G = gt.GF(P_GOLD)
    x = G(rand_limbs(seed + 40, 4, 1 << log_gold, 0xFFFE))
    _ntt_case(f"Goldilocks 2^{log_gold}", G, x, 8, seed, (0,))
    del x

    Fb = gt.GF(P_BLS)
    for log_n in bls_logs:
        x = Fb(rand_limbs(seed + 50 + log_n, 16, 1 << log_n, 0x3FFF))
        _ntt_case(f"BLS12-381 2^{log_n}", Fb, x, 8, seed, (0,))
        del x

    # the integer-array entry points on a small input
    v = np.random.default_rng(seed).integers(0, P_NTT, 1 << 12)
    V, cold, warm = timed(lambda a: gt.ntt(a, modulus=P_NTT), v)
    back = gt.intt(V, modulus=P_NTT)
    ok = np.array_equal(np.asarray(back), v) and _direct_dft_ok(
        v.astype(np.uint64), np.asarray(V)[:8], P_NTT, np.arange(8)
    )
    report("ntt", "gt.ntt / gt.intt 2^12", cold, warm, ok)


# ----------------------------------------------------------------------
# Phase 4: FEC
# ----------------------------------------------------------------------

def _ranks(rng, shape):
    """A random permutation of the positions of each row, as ranks."""
    return rng.random(shape).argsort(axis=1).argsort(axis=1)


def _inject(cw, ranks, lo, hi, values):
    """cw with the positions of per-row rank in [lo, hi) set to
    cw XOR values(shape); returns it and the mask of those positions."""
    import numpy as np

    mask = (ranks >= lo[:, None]) & (ranks < hi[:, None])
    return np.where(mask, cw ^ values(cw.shape), cw), mask


def phase_fec(n_rs: int = 65536, n_bch: int = 16384, seed: int = 0) -> None:
    import jax.numpy as jnp
    import numpy as np

    import galois_tpu as gt

    rng = np.random.default_rng(seed)
    zero = np.zeros(n_rs, np.int64)
    # RS(255,239) puts the decoder's Chien and Forney dots at K = 16, 17
    for k in (239, 223):
        rs = gt.ReedSolomon(255, k)
        GF = rs.field
        msgs = GF((rand_u32(seed + k, (n_rs, rs.k)) & 0xFF).astype(jnp.uint8))
        cw, cold, warm = timed(rs.encode, msgs)
        cw_h = np.asarray(cw.jax)
        msgs_h = np.asarray(msgs.jax)
        ok = np.array_equal(cw_h[:, : rs.k], msgs_h) and not np.asarray(rs.detect(cw)).any()
        report("fec", f"RS(255,{k}) encode {n_rs}", cold, warm, ok)

        # up to t symbol errors per codeword
        n_err = rng.integers(0, rs.t + 1, n_rs)
        rx, _ = _inject(cw_h, _ranks(rng, cw_h.shape), zero, n_err,
                        lambda s: rng.integers(1, 256, s, dtype=np.uint8))
        (dec, nerr), cold, warm = timed(lambda c: rs.decode(c, errors=True), GF(jnp.asarray(rx)))
        ok = np.array_equal(np.asarray(dec.jax), msgs_h) and np.array_equal(nerr, n_err)
        report("fec", f"RS(255,{k}) decode {n_rs}, <= {rs.t} errors", cold, warm, ok)

    # f erasures (any value) and e errors elsewhere, 2e + f <= d - 1 = 32;
    # n_errors counts the errors outside the erased positions
    f = rng.integers(0, rs.d, n_rs)
    e = rng.integers(0, (rs.d - 1 - f) // 2 + 1)
    ranks = _ranks(rng, cw_h.shape)
    rx, era = _inject(cw_h, ranks, zero, f, lambda s: rng.integers(0, 256, s, dtype=np.uint8))
    rx, _ = _inject(rx, ranks, f, f + e, lambda s: rng.integers(1, 256, s, dtype=np.uint8))
    (dec, nerr), cold, warm = timed(lambda c: rs.decode(c, erasures=era, errors=True), GF(jnp.asarray(rx)))
    ok = np.array_equal(np.asarray(dec.jax), msgs_h) and np.array_equal(nerr, e)
    report("fec", f"RS(255,223) decode {n_rs} with erasures, 2e+f <= {rs.d - 1}", cold, warm, ok)

    bch = gt.BCH(511, 493)
    G2 = bch.field
    msgs = G2((rand_u32(seed + 1, (n_bch, bch.k)) & 1).astype(jnp.uint8))
    cw_h = np.asarray(bch.encode(msgs).jax)
    n_err = rng.integers(0, bch.t + 1, n_bch)
    rx, _ = _inject(cw_h, _ranks(rng, cw_h.shape), np.zeros(n_bch, np.int64), n_err,
                    lambda s: np.ones(s, np.uint8))
    (dec, nerr), cold, warm = timed(lambda c: bch.decode(c, errors=True), G2(jnp.asarray(rx)))
    ok = np.array_equal(np.asarray(dec.jax), np.asarray(msgs.jax)) and np.array_equal(nerr, n_err)
    report("fec", f"BCH(511,493) decode {n_bch}, <= {bch.t} errors", cold, warm, ok)


# ----------------------------------------------------------------------
# --four-cards: galois_tpu.parallel over a 1-D mesh
# ----------------------------------------------------------------------

def _spans(arr, n: int) -> bool:
    return len(arr.sharding.device_set) == n


def phase_sharded(n_dev: int = 4, log_n: int = 24, log_bls: int = 22, batch: int = 32,
                  log_batch: int = 20, n_rs: int = 65536, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import galois_tpu as gt
    from galois_tpu.parallel import sharded_batched_fft, sharded_decode, sharded_fft

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))

    def put(F, x, spec):
        return F(jax.device_put(x.jax, NamedSharding(mesh, spec)))

    def check(label, F, x, xs, fn):
        want = np.asarray(np.fft.fft(x).jax)  # single card, same process
        Xs, cold, warm = timed(fn, xs)
        ok = _spans(xs.jax, n_dev) and _spans(Xs.jax, n_dev) and np.array_equal(np.asarray(Xs.jax), want)
        report("sharded", label, cold, warm, ok, devices=len(Xs.jax.sharding.device_set))

    Fp = gt.GF(P_NTT)
    x = Fp(rand_u32(seed, (1 << log_n,)) % P_NTT)
    check(f"sharded_fft GF(3*2^30+1) 2^{log_n}", Fp, x, put(Fp, x, P("x")),
          lambda v: sharded_fft(Fp, v, mesh, "x"))
    Fb = gt.GF(P_BLS)
    x = Fb(rand_limbs(seed + 1, 16, 1 << log_bls, 0x3FFF))
    check(f"sharded_fft BLS12-381 2^{log_bls}", Fb, x, put(Fb, x, P(None, "x")),
          lambda v: sharded_fft(Fb, v, mesh, "x"))
    x = Fp(rand_u32(seed + 2, (batch, 1 << log_batch)) % P_NTT)
    check(f"sharded_batched_fft GF(3*2^30+1) {batch}x2^{log_batch}", Fp, x, put(Fp, x, P("x", None)),
          lambda v: sharded_batched_fft(Fp, v, mesh, "x"))
    del x

    rs = gt.ReedSolomon(255, 223)
    rng = np.random.default_rng(seed)
    cw = np.asarray(rs.encode(rs.field((rand_u32(seed + 3, (n_rs, rs.k)) & 0xFF).astype(jnp.uint8))).jax)
    rx, _ = _inject(cw, _ranks(rng, cw.shape), np.zeros(n_rs, np.int64), rng.integers(0, rs.t + 1, n_rs),
                    lambda s: rng.integers(1, 256, s, dtype=np.uint8))
    want, want_n = rs.decode(rs.field(jnp.asarray(rx)), output="codeword", errors=True)
    rxs = rs.field(jax.device_put(jnp.asarray(rx), NamedSharding(mesh, P("x", None))))
    (dec, nerr), cold, warm = timed(lambda v: sharded_decode(rs, v, mesh, "x"), rxs)
    ok = (_spans(rxs.jax, n_dev) and _spans(dec.jax, n_dev)
          and np.array_equal(np.asarray(dec.jax), np.asarray(want.jax))
          and np.array_equal(np.asarray(nerr), want_n))
    report("sharded", f"sharded_decode RS(255,223) {n_rs}", cold, warm, ok,
           devices=len(dec.jax.sharding.device_set))


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card galois_tpu.parallel path")
    parser.add_argument("--probe", nargs="+", metavar="PART",
                        choices=("dots", "trace", "unroll", "s64", "lookup"),
                        help="run only these kernel-decision measurements "
                             "(benchmarks/kernel_probe.py) on one card")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    import jax

    devices = require_gpu(n_cards)
    cache = use_compile_cache()
    print(f"[device] kind={devices[0].device_kind} count={len(devices)} jax={jax.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile_cache={cache}", flush=True)
    print(card_name_and_power_limit(), flush=True)

    import galois_tpu  # noqa: F401  (enables x64 before any array exists)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_sharded(n_dev=4)
    elif args.probe:
        from benchmarks import kernel_probe

        kernel_probe.run(args.probe)
    else:
        phase_dots()
        phase_fields()
        phase_linalg()
        phase_ntt()
        phase_fec()
    print(f"[done] total_s={time.perf_counter() - t0:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": n_cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
