"""Field-arithmetic benchmark grid, mirroring the reference's pytest-benchmark
suite (reference: benchmarks/test_field_arithmetic.py — GF(2), GF(2^8),
GF(257), GF(3^5), GF(2^32) x 8 ops) plus FEC and FFT grids
(reference: benchmarks/test_fec.py, benchmarks/test_fft.py).

Prints a markdown table of per-op times. Elementwise ops are timed as single
whole-array calls, ended by block_until_ready, on JAX's default device.

Save/compare workflow (counterpart of the reference's pytest-benchmark
--benchmark-save / --benchmark-compare, docs/performance/benchmarks.rst:129-153):

  python benchmarks/bench_grid.py [N] --save NAME      # write results JSON
  python benchmarks/bench_grid.py [N] --compare NAME   # print % deltas vs it

Saved runs live in benchmarks/results/NAME.json.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=5, warmup=2):
    """Best of reps wall seconds of one call, ended by block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _results_path(name):
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}.json")


def main():
    import galois_tpu as gt
    from galois_tpu.ops._kernels import get_ops

    args = [a for a in sys.argv[1:]]
    save_name = compare_name = None
    def _take_opt(flag):
        if flag not in args:
            return None
        i = args.index(flag)
        if i + 1 >= len(args):
            sys.exit(f"usage: bench_grid.py [N] [--save NAME] [--compare NAME] ({flag} needs a NAME)")
        name = args[i + 1]
        del args[i : i + 2]
        return name

    save_name = _take_opt("--save")
    compare_name = _take_opt("--compare")
    N = int(args[0]) if args else 100_000
    record = {}
    rng = np.random.default_rng(0)

    print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)

    # The reference's benchmark grid fields (benchmarks/test_field_arithmetic.py)
    grid = [
        ("GF(2)", 2, "jit-calculate"),
        ("GF(2^8)", 2**8, "jit-lookup"),
        ("GF(2^8)", 2**8, "jit-calculate"),
        ("GF(257)", 257, "jit-lookup"),
        ("GF(257)", 257, "jit-calculate"),
        ("GF(3^5)", 3**5, "jit-lookup"),
        ("GF(3^5)", 3**5, "jit-calculate"),
        ("GF(2^32)", 2**32, "jit-calculate"),
    ]
    opnames = ["add", "subtract", "multiply", "reciprocal", "divide"]

    print(f"| field / mode | {' | '.join(opnames)} | (us, N={N})")
    print("|" + "---|" * (len(opnames) + 2))
    for name, order, mode in grid:
        GF = gt.GF(order)
        ops = get_ops(GF._meta, mode)
        q = order
        a = jnp.asarray(rng.integers(1, q, N, dtype=np.int64).astype(GF._meta.internal_dtype))
        b = jnp.asarray(rng.integers(1, q, N, dtype=np.int64).astype(GF._meta.internal_dtype))
        cells = []
        for opname in opnames:
            fn = getattr(ops, opname)
            if opname in ("reciprocal",):
                t = timeit(jax.jit(fn), a)
            else:
                t = timeit(jax.jit(fn), a, b)
            cells.append(f"{t * 1e6:.1f}")
            record[f"{name} {mode} {opname}_us"] = t * 1e6
        print(f"| {name} {mode} | {' | '.join(cells)} |")

    # FEC grid (reference: benchmarks/test_fec.py — BCH(63,39), RS(63,55), N=1000)
    print()
    for label, make in [
        ("BCH(63,39)", lambda: gt.BCH(63, 39)),
        ("RS(63,55)", lambda: gt.ReedSolomon(63, 55)),
        ("RS(255,223)", lambda: gt.ReedSolomon(255, 223)),
    ]:
        code = make()
        Ncw = 1000
        msgs = code.field.Random((Ncw, code.k), seed=1)
        t_enc = timeit(lambda m: code.encode(m)._data, msgs)
        cws = code.encode(msgs)
        noisy = np.asarray(cws, dtype=np.int64)
        noisy[:, 1] = (noisy[:, 1] + 1) % code.field.order
        t_dec = timeit(lambda c: code.decode(c)._data, code.field(noisy))
        record[f"{label} encode_ms"] = t_enc * 1e3
        record[f"{label} decode_ms"] = t_dec * 1e3
        print(f"{label}: encode {Ncw} cws: {t_enc*1e3:.2f} ms | decode: {t_dec*1e3:.2f} ms "
              f"({Ncw/t_dec:.0f} cw/s)")

    # FFT grid (reference: benchmarks/test_fft.py — sizes 256*K)
    print()
    from galois_tpu.ops._ntt import field_fft

    for K in (1, 4, 16, 64):
        n = 256 * K
        # smallest prime p = m*n + 1
        m = 1
        while not gt.is_prime(m * n + 1):
            m += 1
        GF = gt.GF(m * n + 1)
        x = GF.Random(n, seed=K)
        t = timeit(lambda v: field_fft(v)._data, x)
        record[f"FFT n={n}_us"] = t * 1e6
        print(f"FFT n={n} over {GF.name}: {t * 1e6:.1f} us")

    import json

    if save_name:
        meta = {"n_elems": N, "device": jax.devices()[0].device_kind,
                "date": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        with open(_results_path(save_name), "w") as f:
            json.dump({"meta": meta, "results": record}, f, indent=1, sort_keys=True)
        print(f"\nsaved -> {_results_path(save_name)}")
    if compare_name:
        with open(_results_path(compare_name)) as f:
            base = json.load(f)
        print(f"\ncompare vs '{compare_name}' "
              f"({base['meta'].get('date')}, {base['meta'].get('device')}, "
              f"N={base['meta'].get('n_elems')}):  (negative = faster now)")
        for k in sorted(record):
            if k in base["results"] and base["results"][k] > 0:
                pct = 100.0 * (record[k] - base["results"][k]) / base["results"][k]
                flag = "  <-- regression" if pct > 25 else ""
                print(f"  {k}: {base['results'][k]:.1f} -> {record[k]:.1f}  ({pct:+.0f}%){flag}")


if __name__ == "__main__":
    main()
