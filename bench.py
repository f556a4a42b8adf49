"""Benchmark harness. Prints ONE JSON line on stdout:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Headline: GF(2^8) elementwise multiply throughput. Reference baseline: 10M
elements in 33.9 ms jit-lookup on CPU = 0.295 Gops/s
(docs/performance/binary-extension-fields.rst:43-59).

Two timings per elementwise kernel, both ended by ``block_until_ready``:
- "single": one whole-array op (what a user's one-off call costs);
- "chain": a 64-deep dependent chain in one jit, per op — XLA fuses it, so
  this is the compute-bound ceiling.
Headline = the better of the two. Secondary numbers go to stderr, with the
card's name and power limit. Needs a GPU: it exits non-zero without one.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import card_name_and_power_limit, require_gpu, use_compile_cache

REFERENCE_GF256_MUL_GOPS = 10_000_000 / 33.9e-3 / 1e9  # 0.295 Gops/s
CHAIN = 64


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_call(fn, *args, reps=5, warmup=2):
    """Median wall seconds of one call, ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return _median(times)


def time_single(op, *args, reps=5):
    return time_call(jax.jit(op), *args, reps=reps)


def time_chained(op, x, b, reps=3, depth=CHAIN):
    """Median per-op seconds of y = op(...op(op(x, b), b)..., b), depth deep."""

    @jax.jit
    def chain(x, b):
        return jax.lax.fori_loop(0, depth, lambda i, acc: op(acc, b), x)

    return time_call(chain, x, b, reps=reps, warmup=1) / depth


def _dev_rand_u32(n, seed):
    return jax.random.bits(jax.random.key(seed), (n,), jnp.uint32)


def main():
    devices = require_gpu()
    use_compile_cache()
    print(card_name_and_power_limit(), file=sys.stderr)
    import galois_tpu as gt
    from galois_tpu.ops._kernels import get_ops

    results = {}
    headline = _run(gt, get_ops, results)
    print(json.dumps(results), file=sys.stderr)
    d = devices[0]
    print(json.dumps({
        "metric": "GF(2^8) elementwise multiply",
        "value": headline,
        "unit": "Gops/s",
        "vs_baseline": headline / REFERENCE_GF256_MUL_GOPS,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)},
    }))


def _run(gt, get_ops, results):
    N = 2**26
    results["n_elems"] = N
    rng = np.random.default_rng(0)

    # --- GF(2^8) multiply (headline) ---
    GF256 = gt.GF(2**8)
    meta = GF256._meta
    a = (_dev_rand_u32(N, 1) % 255 + 1).astype(jnp.uint8)
    b = (_dev_rand_u32(N, 2) % 255 + 1).astype(jnp.uint8)
    best = 0.0
    for mode in ("jit-lookup", "jit-calculate"):
        ops = get_ops(meta, mode)
        single = N / time_single(ops.multiply, a, b) / 1e9
        chain = N / time_chained(ops.multiply, a, b) / 1e9
        results[f"gf256_mul_{mode}_gops"] = single
        results[f"gf256_mul_{mode}_chain_gops"] = chain
        best = max(best, single, chain)

    ops = get_ops(meta, "jit-calculate")
    results["gf256_add_gops"] = N / time_single(ops.add, a, b) / 1e9
    results["gf256_recip_gops"] = N / time_chained(lambda acc, _b: ops.reciprocal(acc), a, b) / 1e9

    # --- Goldilocks multiply (planar u16 limbs) ---
    GFg = gt.GF(2**64 - 2**32 + 1)
    og = get_ops(GFg._meta, "jit-calculate")
    w = GFg._meta.storage_width
    Ng = N // 8
    ag = (_dev_rand_u32(Ng * w, 3) & 0xFFFF).astype(jnp.uint16).reshape(w, Ng)
    bg = (_dev_rand_u32(Ng * w, 4) & 0xFFFF).astype(jnp.uint16).reshape(w, Ng)
    results["goldilocks_mul_gops"] = Ng / time_single(og.multiply, ag, bg) / 1e9
    results["goldilocks_mul_chain_gops"] = Ng / time_chained(og.multiply, ag, bg) / 1e9
    # tuple-carry chain: what composite kernels (Horner, pow) pay per multiply
    CHAIN_T = 32

    @jax.jit
    def chain_t(x, y):
        yt = og.split_limbs(y)
        acc = jax.lax.fori_loop(0, CHAIN_T, lambda i, acc: og.multiply_t(acc, yt), og.split_limbs(x))
        return og.join_limbs(acc)

    results["goldilocks_mul_tuple_chain_gops"] = Ng / (time_call(chain_t, ag, bg) / CHAIN_T) / 1e9

    # --- 32-bit prime fields: Mersenne folds, generic u32 Barrett; GF(2^32) ---
    for label, order, n in (("gf_m31", 2**31 - 1, N // 2), ("gf2097169", 2097169, N // 2)):
        o = get_ops(gt.GF(order)._meta, "jit-calculate")
        x = _dev_rand_u32(n, 5) % jnp.uint32(order)
        y = _dev_rand_u32(n, 6) % jnp.uint32(order)
        results[f"{label}_mul_gops"] = n / time_single(o.multiply, x, y) / 1e9
        results[f"{label}_mul_chain_gops"] = n / time_chained(o.multiply, x, y) / 1e9
    o32 = get_ops(gt.GF(2**32)._meta, "jit-calculate")
    x = _dev_rand_u32(N // 4, 21) | jnp.uint32(1)
    y = _dev_rand_u32(N // 4, 22) | jnp.uint32(1)
    results["gf2_32_mul_gops"] = (N // 4) / time_single(o32.multiply, x, y) / 1e9
    results["gf2_32_mul_chain_gops"] = (N // 4) / time_chained(o32.multiply, x, y) / 1e9

    # --- GF(3^5): lookup gathers vs the digit-convolution calculate path ---
    GF243 = gt.GF(3**5)
    N3 = N // 4
    x = (_dev_rand_u32(N3, 13) % 243).astype(GF243._meta.internal_dtype)
    y = (_dev_rand_u32(N3, 14) % 243).astype(GF243._meta.internal_dtype)
    for mode in ("jit-lookup", "jit-calculate"):
        o = get_ops(GF243._meta, mode)
        results[f"gf243_mul_{mode}_gops"] = N3 / time_single(o.multiply, x, y) / 1e9

    # --- Goldilocks batched poly eval ---
    from galois_tpu.ops._poly_eval import evaluate_data

    coeffs = tuple(int(v) for v in rng.integers(1, 2**63, 256, dtype=np.int64))
    pts = (_dev_rand_u32(w * (N // 32), 15) & 0xFFFF).astype(jnp.uint16).reshape(w, N // 32)
    t = time_call(lambda d: evaluate_data(GFg._meta, "jit-calculate", coeffs, d), pts)
    results["goldilocks_polyeval_Mpts_per_s"] = (N // 32) / t / 1e6

    # --- NTTs: int prime (2^20 x32, 2^24 x4), Goldilocks, BLS12-381 ---
    from galois_tpu.ops._ntt import _fft_jit, _get_omega, _plan

    def ntt_ms(F, log_n, batch, seed):
        plan = _plan(F._meta, 2**log_n, _get_omega(F, 2**log_n), "jit-calculate")
        meta = F._meta
        if meta.storage == "int":
            x = (_dev_rand_u32(batch * 2**log_n, seed) % jnp.uint32(meta.characteristic)).reshape(batch, 2**log_n)
        else:
            wl = meta.storage_width
            x = (_dev_rand_u32(wl * batch * 2**log_n, seed) & 0xFFFF).astype(jnp.uint16)
            x = x.reshape(wl, batch, 2**log_n)
            top = 0x3FFF if wl > 4 else 0xFFFE  # values below the field order
            x = x.at[wl - 1].set(jnp.minimum(x[wl - 1], jnp.uint16(top)))
        return time_call(_fft_jit(plan), x, reps=3, warmup=1) / batch * 1e3

    GFn = gt.GF(3 * 2**30 + 1)
    results["ntt_2^20_ms"] = ntt_ms(GFn, 20, 32, 7)
    results["ntt_2^24_ms"] = ntt_ms(GFn, 24, 4, 8)
    results["goldilocks_ntt_2^22_ms"] = ntt_ms(GFg, 22, 4, 9)
    results["goldilocks_ntt_2^24_ms"] = ntt_ms(GFg, 24, 1, 10)
    GFb = gt.GF(52435875175126190479447740508185965837690552500527637822603658699938581184513)
    for lg, batch in ((20, 8), (22, 1), (24, 1)):
        results[f"bls381_ntt_2^{lg}_ms"] = ntt_ms(GFb, lg, batch, 41)
    _fft_jit.cache_clear()
    _plan.cache_clear()

    # --- RS(255,223) and BCH(511,493) batched decode (device decoder) ---
    from galois_tpu.codes._decoder import make_decoder

    rs = gt.ReedSolomon(255, 223)
    B = 65536
    msgs = (_dev_rand_u32(B * 223, 11) & 0xFF).astype(jnp.uint8).reshape(B, 223)
    cn = np.asarray(rs.encode(rs.field(msgs)).jax).copy()
    cn[:, 5] ^= 37
    cn[:, 100] ^= 11
    rdev = jnp.asarray(cn)
    for erasures in (False, True):
        dec = make_decoder(rs.field._meta, "jit-calculate", 256, 255, 255, rs.d, rs.c, int(rs.alpha),
                           with_erasures=erasures)
        args = (rdev, jnp.zeros(rdev.shape, dtype=bool)) if erasures else (rdev,)
        key = "rs255_decode_erasure_path_cw_per_s" if erasures else "rs255_decode_cw_per_s"
        results[key] = B / time_call(dec, *args)

    bch = gt.BCH(511, 493)
    Bb = 16384
    msgs = (_dev_rand_u32(Bb * 493, 12) & 1).astype(jnp.uint8).reshape(Bb, 493)
    cwb = np.asarray(bch.encode(bch.field(msgs)).jax).copy()
    cwb[:, 7] ^= 1
    cwb[:, 100] ^= 1
    ext = bch.extension_field
    decb = make_decoder(ext._meta, "jit-calculate", 2, 511, 511, bch.d, bch.c, int(bch.alpha), with_erasures=False)
    results["bch511_decode_cw_per_s"] = Bb / time_call(decb, jnp.asarray(cwb.astype(ext._meta.internal_dtype)))

    # --- GF(2^8) 256x256 matmul, batched x512 (int8 bit planes) ---
    from galois_tpu.ops._binary_matmul import binary_matmul

    Bt = 512
    Am = (_dev_rand_u32(Bt * 256 * 256, 9) & 0xFF).astype(jnp.uint8).reshape(Bt, 256, 256)
    Bm = (_dev_rand_u32(Bt * 256 * 256, 10) & 0xFF).astype(jnp.uint8).reshape(Bt, 256, 256)
    t = time_call(jax.jit(lambda u, v: binary_matmul(meta, u, v)), Am, Bm)
    results["gf256_matmul256_us"] = t / Bt * 1e6

    return best


if __name__ == "__main__":
    main()
