"""Kernel-decision measurements on an NVIDIA GPU.

The numbers behind the library's choices of kernel form, each part timed
in one process so its two sides share the card's state:

- ``dots``: XLA's raw int8 dot (int32 sums) at every contraction size of
  ``chip_smoke.DOT_KS``, exact or not, and what each dot compiled to
  (cuBLAS, Triton GEMM or a plain fusion). The rule in
  ``ops/_linalg.py::int8_matmul`` rests on it.
- ``trace``: profiler traces of the NTT (p = 3*2^30+1, 2^24 x4) and of the
  RS(255,223) device decoder on 65,536 codewords, the busiest kernels
  of each.
- ``unroll``: unrolled against folded limb combine at BLS12-381 2^22
  (``ops/_kernels.py::unroll_one_shot``).
- ``s64``: an s64 ``jnp.matmul`` against the int8 plane matmul at 1024^2.
- ``lookup``: ``jit-lookup`` against ``jit-calculate`` multiply for
  GF(2^8) at 2^26 and GF(3^5) at 2^24.

Run with ``python chip_smoke.py --probe PART [PART ...]`` from the
repository root. Every line starts with ``[probe]``; times are warm
medians unless named cold.
"""

from __future__ import annotations

import glob
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import P_BLS, P_M31, P_NTT, int8_dot_sweep, rand_limbs, rand_u32

PARTS = ("dots", "trace", "unroll", "s64", "lookup")


def _say(*args) -> None:
    print("[probe]", *args, flush=True)


def bench(name: str, fn, *args, reps: int = 10):
    """Cold (compile + first call) and the median of ``reps`` warm calls."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    _say(f"{name}: cold_s={cold:.6f} warm_median_s={ts[len(ts) // 2]:.6f} "
         f"warm_min_s={ts[0]:.6f} warm_max_s={ts[-1]:.6f}")
    return out


def trace(name: str, fn, *args, reps: int = 3, top: int = 12) -> None:
    """Profile ``reps`` warm calls; print each GPU stream's span, busy time
    and busiest kernels."""
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        path = glob.glob(d + "/**/*.xplane.pb", recursive=True)[0]
        planes = jax.profiler.ProfileData.from_file(path).planes
        for plane in planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                agg, lo, hi = {}, None, None
                for ev in line.events:
                    s, e = ev.start_ns, ev.start_ns + ev.duration_ns
                    lo = s if lo is None else min(lo, s)
                    hi = e if hi is None else max(hi, e)
                    ns, n = agg.get(ev.name, (0.0, 0))
                    agg[ev.name] = (ns + ev.duration_ns, n + 1)
                if not agg:
                    continue
                busy = sum(ns for ns, _ in agg.values())
                _say(f"trace {name} {plane.name} {line.name}: reps={reps} "
                     f"span_ms={(hi - lo) / 1e6:.3f} busy_ms={busy / 1e6:.3f}")
                for k, (ns, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]:
                    _say(f"  {ns / 1e6:10.3f} ms x{n:<5} {k[:110]}")


def probe_dots() -> None:
    failures, kinds = int8_dot_sweep(
        lambda a, b: jnp.matmul(a, b, preferred_element_type=jnp.int32)
    )
    for K, per_shape in kinds.items():
        bad = [f for f in failures if f[0] == K]
        _say(f"raw int8 dot K={K}: kinds={per_shape} exact={'FAIL ' + str(bad) if bad else 'PASS'}")
    _say(f"raw int8 dot failing K: {sorted({f[0] for f in failures})}")


def probe_trace() -> None:
    import galois_tpu as gt
    from galois_tpu.codes._decoder import make_decoder

    Fp = gt.GF(P_NTT)
    x = Fp(rand_u32(1, (4, 1 << 24)) % P_NTT)
    bench("NTT GF(3*2^30+1) 2^24 x4 fft", np.fft.fft, x)
    trace("NTT 2^24 x4", np.fft.fft, x)
    del x
    rs = gt.ReedSolomon(255, 223)
    msgs = rs.field((rand_u32(3, (65536, 223)) & 0xFF).astype(jnp.uint8))
    cw = np.asarray(rs.encode(msgs).jax).copy()
    cw[:, 5] ^= 37
    cw[:, 100] ^= 11
    r = rs.field(jnp.asarray(cw))
    bench("RS(255,223) decode 65536, public rs.decode", lambda c: rs.decode(c, errors=True), r, reps=3)
    dec = make_decoder(rs.field._meta, "jit-calculate", 256, 255, 255, rs.d, rs.c, int(rs.alpha),
                       with_erasures=False)
    bench("RS(255,223) decode 65536, device decoder", dec, r.jax)
    trace("RS(255,223) device decoder", dec, r.jax)


def probe_unroll() -> None:
    import galois_tpu as gt
    from galois_tpu.ops import _kernels
    from galois_tpu.ops._limb_matmul import limb_matmul
    from galois_tpu.ops._ntt import _get_omega, _plan

    Fb = gt.GF(P_BLS)
    meta = Fb._meta
    ops = _kernels.get_ops(meta, "jit-calculate")
    plan = _plan(meta, 1 << 22, _get_omega(Fb, 1 << 22), "jit-calculate")
    A = rand_limbs(10, 16, 1 << 22, 0x3FFF).reshape(16, plan.n1, plan.n2)
    T = rand_limbs(11, 16, 1 << 22, 0x3FFF).reshape(16, plan.n1, plan.n2)
    W = rand_limbs(12, 16, plan.n1 * plan.n1, 0x3FFF).reshape(16, plan.n1, plan.n1)
    policy = _kernels.unroll_one_shot
    outs = {}
    try:
        for form in ("unrolled", "fold"):
            _kernels.unroll_one_shot = lambda *_, u=(form == "unrolled"): u
            # the NTT twiddle is one storage-level multiply
            mul = jax.jit(ops.multiply)
            outs[form] = np.asarray(bench(f"BLS12-381 2^22 twiddle {form}", mul, A, T, reps=5))
            bench(f"BLS12-381 2^22 side matmul {plan.n1}^3 {form}",
                  jax.jit(lambda w, m: limb_matmul(meta, w, m)), W, A, reps=3)
            bench(f"BLS12-381 multiply 2^16 {form}", jax.jit(ops.multiply),
                  A[:, :256, :256], T[:, :256, :256], reps=5)
    finally:
        _kernels.unroll_one_shot = policy
    _say(f"twiddle forms agree: {np.array_equal(outs['unrolled'], outs['fold'])}")


def probe_s64() -> None:
    from galois_tpu.ops._linalg import _prime_matmul_planes

    for p in (65537, P_M31):
        a = rand_u32(20, (1024, 1024)) % p
        b = rand_u32(21, (1024, 1024)) % p
        planes = bench(f"matmul 1024^2 p={p} int8 planes",
                       jax.jit(lambda u, v, p=p: _prime_matmul_planes(u, v, p, 1024)), a, b)
        if (p - 1) ** 2 * 1024 < 2**62:  # the s64 sums must not overflow
            s64 = bench(f"matmul 1024^2 p={p} s64 dot",
                        jax.jit(lambda u, v, p=p: jnp.matmul(u.astype(jnp.int64), v.astype(jnp.int64)) % p),
                        a, b)
            _say(f"p={p}: s64 and planes agree: "
                 f"{np.array_equal(np.asarray(s64), np.asarray(planes).astype(np.int64))}")


def probe_lookup() -> None:
    import galois_tpu as gt

    for q, log_n in ((2**8, 26), (3**5, 24)):
        F = gt.GF(q)
        x = F((rand_u32(30, (1 << log_n,)) % q).astype(F._meta.internal_dtype))
        y = F((rand_u32(31, (1 << log_n,)) % q).astype(F._meta.internal_dtype))
        try:
            for mode in ("jit-calculate", "jit-lookup"):
                F.compile(mode)
                bench(f"GF({q}) multiply 2^{log_n} {mode}", jax.jit(lambda u, v: u * v), x, y)
        finally:
            F.compile("jit-calculate")


def run(parts) -> None:
    for part in parts:
        globals()[f"probe_{part}"]()
