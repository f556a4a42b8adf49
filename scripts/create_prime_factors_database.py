"""Build the prime-factors database for Cunningham-style numbers b^n +- 1.

Offline analogue of the reference's scripts/create_prime_factors_database.py
(which scrapes the Cunningham-project tables; reference
src/galois/_databases/_interface.py:31-75 defines the consumer interface).
This environment has no network egress, so the table is *computed* instead:

- b^n - 1 = prod_{d | n} Phi_d(b)  (cyclotomic decomposition), and
  b^n + 1 = prod_{d | 2n, d !| n} Phi_d(b), so each cyclotomic value
  Phi_d(b) is factored exactly once and the per-(b, n) factorizations are
  assembled by multiplying the parts. This mirrors how the Cunningham
  tables themselves are organized.
- Each Phi_d(b) is factored with sympy.factorint under a SIGALRM wall-clock
  cap; parts that time out leave a residual composite, which the database
  stores (the reference DB also carries residual composites — fetch()
  returns (factors, multiplicities, composite)).

Output: galois_tpu/_databases/prime_factors.txt.gz, one line per value:
    <value> <p1>,<p2>,... <e1>,<e2>,... <residual_composite>
with '-' for an empty factor list.

Usage: python scripts/create_prime_factors_database.py [--timeout SECS] [--jobs N]
"""

from __future__ import annotations

import argparse
import gzip
import multiprocessing as mp
import pathlib
import signal
import sys
import time

import sympy

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "galois_tpu" / "_databases" / "prime_factors.txt.gz"

# Cunningham bases and exponent caps (the classic tables use the same bases
# with larger caps; these finish offline in under an hour on 4 cores).
BASES = {2: 256, 3: 160, 5: 120, 6: 100, 7: 100, 10: 100, 11: 88, 12: 88}

_TIMEOUT = 5.0

# Published prime factors (Fermat numbers / Cunningham project) for parts the
# offline factorizer cannot crack in bounded time. Every candidate is verified
# (primality + divisibility) before use, so a wrong entry is silently ignored
# rather than corrupting the table.
KNOWN_PRIMES = [
    # F7 = 2^128 + 1 (Morrison & Brillhart 1970)
    59649589127497217,
    5704689200685129054721,
    # F8 = 2^256 + 1 (Brent & Pollard 1980)
    1238926361552897,
    93461639715357977769163558199606896584051237541638188580280321,
]


def _divide_known(rem: int, found: dict[int, int]) -> int:
    """Peel verified published primes off a residual composite."""
    for q in KNOWN_PRIMES:
        while rem % q == 0 and sympy.isprime(q):
            found[q] = found.get(q, 0) + 1
            rem //= q
    if rem > 1 and sympy.isprime(rem):
        found[rem] = found.get(rem, 0) + 1
        rem = 1
    return rem


class _Timeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise _Timeout


def _init_worker(timeout: float) -> None:
    global _TIMEOUT
    _TIMEOUT = timeout
    signal.signal(signal.SIGALRM, _alarm)


def _factor_task(task: tuple[int, int]) -> tuple[tuple[int, int], dict, int]:
    """Factor Phi_d(b); returns ((b, d), {p: e}, residual_composite)."""
    b, d = task
    val = int(sympy.cyclotomic_poly(d, b)) if d > 1 else b - 1
    if val == 1:
        return task, {}, 1
    if sympy.isprime(val):
        return task, {val: 1}, 1
    signal.setitimer(signal.ITIMER_REAL, _TIMEOUT)
    try:
        fac = dict(sympy.factorint(val))
        signal.setitimer(signal.ITIMER_REAL, 0)
        return task, fac, 1
    except _Timeout:
        pass
    # Salvage the easy part: bounded trial division, keep the composite rest.
    signal.setitimer(signal.ITIMER_REAL, _TIMEOUT)
    try:
        limited = sympy.factorint(val, limit=10_000)
    except _Timeout:
        limited = {val: 1}
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
    found: dict[int, int] = {}
    rem = 1
    for p, e in limited.items():
        if sympy.isprime(p):
            found[p] = found.get(p, 0) + e
        else:
            rem *= p**e
    rem = _divide_known(rem, found)
    return task, found, rem


def refine_existing() -> None:
    """Re-process the shipped table: peel KNOWN_PRIMES off residual composites
    (and promote residuals that are themselves prime) without re-factoring."""
    n_fixed = 0
    lines_out: list[str] = []
    with gzip.open(OUT, "rt") as fh:
        for line in fh:
            value_s, p_str, e_str, rem_s = line.split()
            rem = int(rem_s)
            fac: dict[int, int] = {}
            if p_str != "-":
                for p, e in zip(p_str.split(","), e_str.split(",")):
                    fac[int(p)] = int(e)
            if rem > 1:
                new_rem = _divide_known(rem, fac)
                if new_rem != rem:
                    n_fixed += 1
                    rem = new_rem
            ps = sorted(fac)
            p_out = ",".join(str(p) for p in ps) if ps else "-"
            e_out = ",".join(str(fac[p]) for p in ps) if ps else "-"
            lines_out.append(f"{value_s} {p_out} {e_out} {rem}")
    with gzip.open(OUT, "wt") as fh:
        fh.write("\n".join(lines_out) + "\n")
    print(f"refined {n_fixed} entries in {OUT}", file=sys.stderr)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--jobs", type=int, default=max(1, mp.cpu_count() - 1))
    ap.add_argument(
        "--refine-only",
        action="store_true",
        help="only peel KNOWN_PRIMES off residuals in the existing table",
    )
    args = ap.parse_args()
    if args.refine_only:
        refine_existing()
        return

    # Every cyclotomic index needed: d | n (minus side) or d | 2n (plus side).
    tasks = sorted(
        {(b, d) for b, cap in BASES.items() for n in range(2, cap + 1) for d in sympy.divisors(2 * n)},
        key=lambda t: (t[1], t[0]),  # small d first: fast tasks stream early
    )
    t0 = time.time()
    phi: dict[tuple[int, int], tuple[dict, int]] = {}
    with mp.get_context("fork").Pool(args.jobs, _init_worker, (args.timeout,)) as pool:
        for i, (key, fac, rem) in enumerate(pool.imap_unordered(_factor_task, tasks, chunksize=1)):
            phi[key] = (fac, rem)
            if (i + 1) % 200 == 0:
                print(f"{i + 1}/{len(tasks)} cyclotomic parts ({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)

    def assemble(b: int, ds: list[int]) -> tuple[dict[int, int], int]:
        total: dict[int, int] = {}
        residual = 1
        for d in ds:
            fac, rem = phi[(b, d)]
            for p, e in fac.items():
                total[p] = total.get(p, 0) + e
            residual *= rem
        return total, residual

    lines: list[str] = []
    seen: set[int] = set()
    n_full = n_partial = 0
    for b, cap in BASES.items():
        for n in range(2, cap + 1):
            minus = (b**n - 1, *assemble(b, sympy.divisors(n)))
            plus = (b**n + 1, *assemble(b, [d for d in sympy.divisors(2 * n) if n % d != 0]))
            for value, fac, rem in (minus, plus):
                if value in seen:
                    continue
                seen.add(value)
                ps = sorted(fac)
                p_str = ",".join(str(p) for p in ps) if ps else "-"
                e_str = ",".join(str(fac[p]) for p in ps) if ps else "-"
                lines.append(f"{value} {p_str} {e_str} {rem}")
                if rem == 1:
                    n_full += 1
                else:
                    n_partial += 1

    OUT.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(OUT, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    print(
        f"wrote {OUT}: {len(lines)} entries ({n_full} complete, {n_partial} "
        f"with residual composites) in {time.time() - t0:.0f}s",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
