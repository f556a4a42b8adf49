"""galois_tpu: Galois-field computation on accelerators, in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
`galois` library: finite-field arrays GF(p^m), polynomials, FEC codes
(BCH/Reed-Solomon), LFSRs, the NTT, finite-field linear algebra, and a
number-theory toolbox — built for devices (jit/vmap/shard_map over device
meshes; multi-limb modular arithmetic in 32-bit lanes; exact int8-plane
matmuls).
"""

import jax as _jax

# Exact 64-bit integer arithmetic is load-bearing for large prime fields.
_jax.config.update("jax_enable_x64", True)

try:
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("galois-tpu")
except Exception:  # not installed (source-tree import)
    __version__ = "0.2.0"

from ._options import get_printoptions, printoptions, set_printoptions  # noqa: E402
from . import typing  # noqa: E402
from .fields import (  # noqa: E402
    GF,
    GF2,
    Field,
    FieldArray,
    FieldArrayMeta,
    is_normal_element,
    is_primitive_element,
    normal_element,
    normal_elements,
    primitive_element,
    primitive_elements,
)
from .nt import (  # noqa: E402
    carmichael_lambda,
    divisor_sigma,
    divisors,
    euler_phi,
    fermat_primality_test,
    ilog,
    iroot,
    is_composite,
    is_cyclic,
    is_perfect_power,
    is_powersmooth,
    is_prime,
    is_prime_power,
    is_primitive_root,
    is_smooth,
    isqrt,
    jacobi_symbol,
    kronecker_symbol,
    kth_prime,
    legendre_symbol,
    mersenne_exponents,
    mersenne_primes,
    miller_rabin_primality_test,
    mobius,
    next_prime,
    perfect_power,
    pollard_p1,
    pollard_rho,
    prev_prime,
    primes,
    primitive_root,
    primitive_roots,
    random_prime,
    totatives,
    trial_division,
)
from .codes import (  # noqa: E402
    BCH,
    ReedSolomon,
    generator_to_parity_check_matrix,
    parity_check_to_generator_matrix,
)
from .lfsr import FLFSR, GLFSR, berlekamp_massey  # noqa: E402
from .transforms import intt, ntt  # noqa: E402
from .polys import (  # noqa: E402
    Poly,
    conway_poly,
    irreducible_poly,
    irreducible_polys,
    lagrange_poly,
    matlab_primitive_poly,
    primitive_poly,
    primitive_polys,
)

# Polymorphic int/Poly functions shadow the int-only nt versions
# (reference: src/galois/_polymorphic.py).
from ._polymorphic import (  # noqa: E402
    are_coprime,
    crt,
    egcd,
    factors,
    gcd,
    is_square_free,
    lcm,
    prod,
)

# The abstract array base class (reference: galois.Array).
from .fields._array import Array  # noqa: E402
