"""Lookup databases: Conway polynomials, minimal-term irreducible polynomials.

In-memory analogue of the reference's SQLite layer (reference:
src/galois/_databases/_interface.py:31-158). Data is packed .npz (built by
scripts/extract_reference_dbs.py from the public Luebeck/Wolfram tables) and
loaded once into an in-memory dict — no connection/locking machinery needed.

The reference's third database (Cunningham-book prime factorizations,
prime_factors.db) is absent from its checkout, so the table here is
*computed* by scripts/create_prime_factors_database.py (cyclotomic
decomposition of b^n +- 1, per-part factorization) and stored as gzipped
text; `fetch` mirrors the reference's 3-tuple contract including residual
composites (reference src/galois/_databases/_interface.py:38-75).
"""

from __future__ import annotations

import functools
import io
from importlib import resources
from typing import Dict, List, Tuple

import numpy as np


def _read_data(filename: str) -> bytes:
    # importlib.resources (not a raw __file__ path): works from a wheel /
    # zipimport as well as a source tree.
    return resources.files(__package__).joinpath(filename).read_bytes()

__all__ = ["ConwayPolyDatabase", "IrreduciblePolyDatabase", "PrimeFactorsDatabase"]


class _SparsePolyDatabase:
    """Maps (characteristic, degree) -> (nonzero_degrees, nonzero_coeffs)."""

    filename: str = ""

    def __init__(self):
        with np.load(io.BytesIO(_read_data(self.filename))) as z:
            index = z["index"]
            self._degrees = z["degrees"]
            self._coeffs = z["coeffs"]
        self._table: Dict[Tuple[int, int], Tuple[int, int]] = {
            (int(p), int(m)): (int(off), int(cnt)) for p, m, off, cnt in index
        }

    def fetch(self, characteristic: int, degree: int) -> Tuple[List[int], List[int]]:
        key = (int(characteristic), int(degree))
        if key not in self._table:
            raise LookupError(
                f"{type(self).__name__} has no entry for "
                f"GF({characteristic}^{degree})."
            )
        off, cnt = self._table[key]
        return (
            [int(d) for d in self._degrees[off : off + cnt]],
            [int(c) for c in self._coeffs[off : off + cnt]],
        )

    def __contains__(self, key: Tuple[int, int]) -> bool:
        return (int(key[0]), int(key[1])) in self._table


class _ConwayPolyDatabase(_SparsePolyDatabase):
    filename = "conway_polys.npz"


class _IrreduciblePolyDatabase(_SparsePolyDatabase):
    filename = "irreducible_polys.npz"


class _PrimeFactorsDatabase:
    """Cunningham-style factorizations of b^n +- 1.

    fetch(n) -> (factors, multiplicities, residual_composite), matching the
    reference's contract (src/galois/_databases/_interface.py:38-75): a
    residual composite of 1 means the factorization is complete. Missing
    data file degrades to an always-miss stub.
    """

    filename = "prime_factors.txt.gz"

    def __init__(self):
        self._table: Dict[int, Tuple[List[int], List[int], int]] = {}
        res = resources.files(__package__).joinpath(self.filename)
        if not res.is_file():
            return
        import gzip

        with gzip.open(io.BytesIO(res.read_bytes()), "rt") as fh:
            for line in fh:
                value_s, p_str, e_str, rem_s = line.split()
                ps = [] if p_str == "-" else [int(x) for x in p_str.split(",")]
                es = [] if e_str == "-" else [int(x) for x in e_str.split(",")]
                self._table[int(value_s)] = (ps, es, int(rem_s))

    def fetch(self, n: int) -> Tuple[List[int], List[int], int]:
        entry = self._table.get(int(n))
        if entry is None:
            raise LookupError(f"PrimeFactorsDatabase has no entry for {n}.")
        ps, es, rem = entry
        return list(ps), list(es), rem

    def __contains__(self, n: int) -> bool:
        return int(n) in self._table


@functools.lru_cache(maxsize=None)
def ConwayPolyDatabase() -> _ConwayPolyDatabase:
    return _ConwayPolyDatabase()


@functools.lru_cache(maxsize=None)
def IrreduciblePolyDatabase() -> _IrreduciblePolyDatabase:
    return _IrreduciblePolyDatabase()


@functools.lru_cache(maxsize=None)
def PrimeFactorsDatabase() -> _PrimeFactorsDatabase:
    return _PrimeFactorsDatabase()
