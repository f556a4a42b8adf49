"""Sharded-NTT scaling harness (SURVEY §7 M6).

Measures a size-N NTT on 1 device and on D devices (the real devices when
there are several, else a virtual CPU mesh) and reports scaling efficiency:

    eff = t_1 / (D * t_D)

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/bench_scaling.py [log2_N]
"""

import os
import sys
import time

import numpy as np

# `python benchmarks/bench_scaling.py` puts benchmarks/ (not the repo root)
# on sys.path; the package is not installed, so add the root explicitly.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=5, warmup=2):
    """Best of reps wall seconds of one call, ended by block_until_ready."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    from jax.sharding import Mesh

    import galois_tpu as gt
    from galois_tpu.ops._ntt import _fft_jit, _get_omega, _plan
    from galois_tpu.parallel._ntt_sharded import ShardedFFTPlan

    log2N = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    N = 1 << log2N
    devices = jax.devices()
    D = len(devices)
    p = 3 * 2**30 + 1
    F = gt.GF(p)
    rng = np.random.default_rng(0)
    x = np.asarray(rng.integers(0, p, N, dtype=np.int64).astype(np.uint32))
    import jax.numpy as jnp

    xd = jnp.asarray(x)

    omega = _get_omega(F, N)
    plan1 = _plan(F._meta, N, omega, "jit-calculate")
    t1 = timeit(_fft_jit(plan1), xd)
    print(f"1-device NTT 2^{log2N}: {t1*1e3:.3f} ms ({1/t1:.0f} xforms/s)")

    # Sweep sub-meshes D = 2, 4, ... up to the device count. On a virtual
    # CPU mesh every "device" shares the same physical cores, so the
    # efficiency column measures ORCHESTRATION OVERHEAD ONLY (collective
    # scheduling + layout churn), not real interconnect scaling.
    mesh = None
    subD = 2
    while subD <= D:
        submesh = Mesh(np.array(devices[:subD]).reshape(subD), ("x",))
        if subD == D:
            mesh = submesh
        splan = ShardedFFTPlan(F._meta, N, omega, "jit-calculate", submesh, "x")
        tD = timeit(splan, xd)
        eff = t1 / (subD * tD)
        print(
            f"{subD}-device sharded NTT: {tD*1e3:.3f} ms "
            f"(speedup {t1/tD:.2f}x, efficiency {eff*100:.0f}%)"
        )
        subD *= 2
    if D == 1:
        print("single device only — run with a mesh for scaling numbers")

    # --- RS(255,223) decode scaling (embarrassingly parallel batch) ---
    rs = gt.ReedSolomon(255, 223)
    B = max(D, 1) * 256
    msgs = rs.field.Random((B, 223), seed=1)
    cws = np.asarray(rs.encode(msgs), dtype=np.int64)
    cws[:, 7] ^= 99
    from galois_tpu.codes._decoder import make_decoder

    dec = make_decoder(
        rs.field._meta, rs.field._meta.default_ufunc_mode, rs.field.order,
        255, 255, rs.d, rs.c, int(rs.alpha), with_erasures=False,
    )
    r1 = jnp.asarray(cws.astype(np.uint8))
    t1 = timeit(dec, r1, reps=3, warmup=1)
    print(f"1-device RS(255,223) decode B={B}: {t1*1e3:.2f} ms ({B/t1:.0f} cw/s)")
    if D > 1:
        from galois_tpu.parallel import sharded_decode

        def run(batch):
            out, nerr = sharded_decode(rs, batch, mesh, "x")
            return out._data

        tD = timeit(run, cws, reps=3, warmup=1)
        eff = t1 / (D * tD)
        print(
            f"{D}-device sharded decode: {tD*1e3:.2f} ms "
            f"(speedup {t1/tD:.2f}x, efficiency {eff*100:.0f}%)"
        )


if __name__ == "__main__":
    main()
