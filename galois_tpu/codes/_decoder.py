"""Batched BCH / Reed-Solomon decoder.

A batched re-design of the reference's per-codeword JIT pipeline
(reference: src/galois/_codes/_bch.py:1336-1576): every stage — syndromes,
erasure locator, Berlekamp-Massey, Chien search, Forney — is a fixed-shape,
branch-free computation batched over codewords. The reference's early-`continue`
failure paths become failure masks; its data-dependent BM update becomes a
masked shift-register formulation; its Chien loop becomes one evaluation
against a host-precomputed (design_n x d) locator-power matrix. Decoding N
codewords is a single XLA program that shards trivially over the batch axis.

Algorithm steps mirror the reference exactly (bit-exact on success paths):
 1. syndromes S_l = r(alpha^(c+l))
 2. erasure locator Gamma(x) = prod (1 - Y_k x)
 3. modified syndromes S' = Gamma * S mod x^(d-1)
 4. Berlekamp-Massey on S'[u:] -> error locator Lambda(x)
 5. Lambda_total = Gamma * Lambda; bound check 2v + u <= d-1
 6. Chien search over i in [0, design_n)
 7. evaluator Omega' = Lambda * S' mod x^(d-1)
 8. formal derivative of Lambda_total
 9. generalized Forney error values E_j = -Omega'(Xj^-1)/Lambda'(Xj^-1) * Xj^(1-c)
10. correction in the base field; n_errors = v, or -1 on failure
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields._hostfield import get_host_field
from ..fields._meta import FieldMeta
from ..ops._kernels import get_ops
from ..ops._linalg import int8_matmul


# Bounded: each decoder holds compiled XLA executables, and every live
# executable pins ~50 memory mappings. An unbounded cache exhausts the
# kernel's vm.max_map_count (65530) near ~1000 live programs — observed as
# an LLVM abort at ~96% of the exhaustive 260-code golden matrix. LRU
# eviction lets GC unmap retired decoders; 96 is far above any real
# working set.
@functools.lru_cache(maxsize=96)
def make_decoder(
    ext_meta: FieldMeta,
    mode: str,
    base_order: int,
    n: int,
    design_n: int,
    d: int,
    c: int,
    alpha_int: int,
    with_erasures: bool = True,
):
    """Build the jitted batched decoder for received length n (<= design_n).

    ``with_erasures=False`` builds the erasure-free specialization: no
    erasure-locator scan, unmodified syndromes, and Berlekamp-Massey
    windows as dynamic slices instead of per-row gathers — the common
    decode path.
    """
    assert ext_meta.storage == "int", "FEC syndrome fields use int storage"
    ops = get_ops(ext_meta, mode)
    hf = get_host_field(ext_meta)
    dt = ext_meta.internal_dtype
    nroots = d - 1
    p_char = ext_meta.characteristic

    # ---- host-precomputed constant tables (int reprs) ----
    # Positions are ascending-degree indices of the *shortened* received word:
    # position j <-> coefficient of x^j, locator Y_j = alpha^j.
    apow = [1] * max(design_n + 1, 2)
    for i in range(1, design_n + 1):
        apow[i] = hf.multiply(apow[i - 1], alpha_int)
    a_inv = hf.reciprocal(alpha_int)
    ainv_pow = [1] * (design_n + 1)
    for i in range(1, design_n + 1):
        ainv_pow[i] = hf.multiply(ainv_pow[i - 1], a_inv)

    # Syndrome matrix W[j, l] = alpha^((c+l) * j), j < n, l < d-1
    W = np.zeros((n, nroots), dtype=np.int64)
    for j in range(n):
        base = hf.power(alpha_int, j)
        cur = hf.power(base, c)
        for l in range(nroots):
            W[j, l] = cur
            cur = hf.multiply(cur, base)

    # Chien matrix CH[i, j] = alpha^(-i*j), i < design_n, j < 2d (max degree of
    # Lambda_total is d-1; keep d columns)
    Lmax = d  # Lambda_total has degree <= d-1 -> d coefficients
    CH = np.zeros((design_n, Lmax), dtype=np.int64)
    for i in range(design_n):
        xinv = ainv_pow[i]
        cur = 1
        for j in range(Lmax):
            CH[i, j] = cur
            cur = hf.multiply(cur, xinv)

    # Forney position constants: for position i < n: Xi^(1-c) = (alpha^-i)^(c-1)
    FP = np.zeros(n, dtype=np.int64)
    for i in range(n):
        FP[i] = hf.power(ainv_pow[i], c - 1)

    Y = np.array([apow[j] for j in range(n)], dtype=np.int64)  # locators

    if with_erasures:
        # --- evaluation-interpolation Gamma build (host constants) ---
        # Gamma(x) = prod_{erased j} (1 - Y_j x) has degree <= d-1, so it is
        # determined by its values at d fixed points z_k. Each value is a
        # product over erased factors, i.e. a SUM of discrete logs linear in
        # the erasure mask: one (B, n) @ (n, d) integer matmul
        # replaces the former top_k + locator gather + d-step scan. The
        # coefficients come back via one exact field matmul with the
        # host-inverted Vandermonde of the z_k. Bit-exact with reference
        # step (2) (src/galois/_codes/_bch.py:1389-1393).
        from ..fields._tables import build_exp_log

        q = ext_meta.order
        g_int = ext_meta.primitive_element_int  # group generator (alpha may not be)
        _, LOG_np = build_exp_log(ext_meta)
        zs = [0] + [apow[k] for k in range(d - 1)]  # d distinct points, z_0 = 0
        LT = np.zeros((n, d), dtype=np.int64)  # log_g(1 - Y_j z_k); 0 at zero factors
        zero_j = [-1] * d  # position whose factor vanishes at z_k (at most one)
        for k in range(1, d):
            for j in range(n):
                f = hf.subtract(1, hf.multiply(int(Y[j]), int(zs[k])))
                if f == 0:
                    zero_j[k] = j
                else:
                    LT[j, k] = int(LOG_np[int(f)])
        # Vandermonde V[k, t] = z_k^t and its exact field inverse (host)
        V = [[hf.power(zs[k], t) for t in range(d)] for k in range(d)]
        M_ = [row[:] + [1 if i == j else 0 for j in range(d)] for i, row in enumerate(V)]
        for col in range(d):  # Gauss-Jordan over the field, exact ints
            piv = next(r for r in range(col, d) if M_[r][col] != 0)
            M_[col], M_[piv] = M_[piv], M_[col]
            inv_p = hf.reciprocal(M_[col][col])
            M_[col] = [hf.multiply(v, inv_p) for v in M_[col]]
            for r in range(d):
                if r != col and M_[r][col] != 0:
                    f = M_[r][col]
                    M_[r] = [hf.subtract(v, hf.multiply(f, w)) for v, w in zip(M_[r], M_[col])]
        # (d, d) with Vinv_T[k, t] = Vinv[t, k]: coeffs = vals @ Vinv_T
        Vinv_T = np.array(
            [[M_[r][d + c] for c in range(d)] for r in range(d)], dtype=np.int64
        ).T
        # 7-bit planes of LT for exact int8 matmuls (log values < q-1)
        n_log_planes = max(1, -(-(q - 1).bit_length() // 7))
        LT_planes = [((LT >> (7 * i)) & 127).astype(np.int8) for i in range(n_log_planes)]
        g_nbits = (q - 1).bit_length()

    def fmatmul(X, Mconst_np):
        """(B, K) @ (K, N) with a host-constant matrix — int8 bit planes for
        binary extension fields, masked field-dot otherwise."""
        from ..ops._binary_matmul import binary_matmul
        from ..ops._binary_matmul import supports as bin_supports
        from ..ops._digit_matmul import digit_matmul
        from ..ops._digit_matmul import supports as dig_supports

        K = X.shape[-1]
        Md = jnp.asarray(Mconst_np.astype(np.int64)).astype(dt)
        if bin_supports(ext_meta, K):
            return binary_matmul(ext_meta, X, Md)
        if dig_supports(ext_meta, K):
            return digit_matmul(ext_meta, X, Md)
        prod = ops.multiply(X[:, :, None], Md[None, :, :])
        out = prod
        size = out.shape[1]
        while size > 1:
            half = size // 2
            a_ = out[:, :half]
            b_ = out[:, half : 2 * half]
            rem = out[:, 2 * half :]
            out = jnp.concatenate([ops.add(a_, b_), rem], axis=1)
            size = half + (size - 2 * half)
        return jnp.squeeze(out, axis=1)

    def field_dot(A, B, axis):
        prod = ops.multiply(A, B)
        out = prod
        size = out.shape[axis]
        while size > 1:
            half = size // 2
            a = jax.lax.slice_in_dim(out, 0, half, axis=axis)
            b = jax.lax.slice_in_dim(out, half, 2 * half, axis=axis)
            rem = jax.lax.slice_in_dim(out, 2 * half, size, axis=axis)
            out = jnp.concatenate([ops.add(a, b), rem], axis=axis)
            size = half + (size - 2 * half)
        return jnp.squeeze(out, axis=axis)

    def conv_trunc(A, B, out_len):
        """Batched poly multiply (ascending coeffs): A (B, la), B (B, lb) ->
        (B, out_len) truncated.

        One-shot: ONE field multiply builds the full (B, lb, la) outer
        product, a pad+reshape SHEAR aligns row j at offset j (row j of a
        right-zero-padded (lb, la+lb) block starts at j*(la+lb), so
        reslicing the flat buffer with stride la+lb-1 lands element
        [j, k-j] at [j, k] and reads zeros elsewhere), and a log2(lb)
        tree of field adds folds the anti-diagonals. Replaces lb
        SEQUENTIAL multiply+slice+update steps — the decoder is latency-
        bound at production batch sizes and runs up to three of these per
        decode."""
        la, lb = A.shape[1], B.shape[1]
        nbatch = A.shape[0]
        full = la + lb - 1
        P = ops.multiply(A[:, None, :], B[:, :, None])  # (B, lb, la)
        Ppad = jnp.pad(P, ((0, 0), (0, 0), (0, lb)))  # (B, lb, la + lb)
        flat = Ppad.reshape(nbatch, lb * (la + lb))
        sheared = flat[:, : lb * full].reshape(nbatch, lb, full)
        out = sheared
        rows = lb
        while rows > 1:
            half = rows // 2
            out = jnp.concatenate(
                [ops.add(out[:, :half], out[:, half : 2 * half]), out[:, 2 * half : rows]],
                axis=1,
            )
            rows = half + (rows - 2 * half)
        out = out[:, 0, :]
        if full > out_len:
            out = out[:, :out_len]
        elif full < out_len:
            out = jnp.pad(out, ((0, 0), (0, out_len - full)))
        return out

    def berlekamp_massey(Sp, u, B):
        """Masked-scan BM over the modified syndromes S', starting at the
        per-row offset u (the erasure count) — step t is a no-op while
        t < u_b, and relative step indices are t - u_b, so NO per-row
        shift/gather of the syndrome rows is needed (take_along_axis was
        the erasure path's one real gather). The per-step window is ONE
        dynamic slice of a zero-padded buffer; delta = dot(rev(C), ascending window)."""
        C0 = jnp.zeros((B, d), dtype=dt).at[:, 0].set(1)
        Bp0 = jnp.zeros((B, d), dtype=dt).at[:, 0].set(1)
        L0 = jnp.zeros((B,), dtype=jnp.int32)
        bb0 = jnp.ones((B,), dtype=dt)
        # Z[:, d + j] = S'[j]; window [S'_{t-d+1} .. S'_t] = Z[:, t+1 : t+1+d]
        Z = jnp.concatenate([jnp.zeros((B, d), dtype=dt), Sp], axis=1)

        def bm_step(carry, t):
            C, Bp, L, bb = carry
            active = t >= u  # (B,); rows with more erasures start later
            win = jax.lax.dynamic_slice_in_dim(Z, t + 1, d, axis=1)
            delta = field_dot(jnp.flip(C, axis=1), win, axis=1)  # (B,)
            # shift B first (maintains x^m * B implicitly)
            Bp_shift = jnp.roll(Bp, 1, axis=1).at[:, 0].set(0)
            coef = ops.multiply(delta, ops.reciprocal(bb))
            C_new = ops.subtract(C, ops.multiply(Bp_shift, coef[:, None]))
            upd = active & (delta != 0)
            grow = upd & (2 * L <= t - u)
            # inactive rows (t < u_b) must not pre-shift their B register
            Bp = jnp.where(
                active[:, None], jnp.where(grow[:, None], C, Bp_shift), Bp
            )
            bb = jnp.where(grow, delta, bb)
            L = jnp.where(grow, (t - u + 1 - L).astype(jnp.int32), L)
            C = jnp.where(upd[:, None], C_new, C)
            return (C, Bp, L, bb), None

        (C, _, L, _), _ = jax.lax.scan(
            bm_step, (C0, Bp0, L0, bb0), jnp.arange(nroots, dtype=jnp.int32)
        )
        return C, L

    @jax.jit
    def decode_with_erasures(received, erasures):
        """received: (B, n) ext-field int storage, DESCENDING degree order
        (as passed by users); erasures: (B, n) bool, same order."""
        B = received.shape[0]
        r = jnp.flip(received, axis=1).astype(dt)   # ascending degrees
        era = jnp.flip(erasures, axis=1)
        u = jnp.sum(era, axis=1).astype(jnp.int32)  # erasure counts

        fail = u > nroots

        r_z = jnp.where(era, jnp.zeros_like(r), r)

        # 1. syndromes: S[b, l] = sum_j r_z[b, j] * W[j, l]
        S = fmatmul(r_z, W)  # (B, d-1)

        # 2. erasure locator Gamma (ascending, d coeffs) by evaluation-
        # interpolation: log Gamma(z_k) is LINEAR in the erasure mask, so
        # one (B, n) @ (n, d) int8 matmul of the mask against the
        # host log table gives every evaluation; vanishing factors (z_k an
        # inverse locator of an erased position) are patched to exact 0;
        # one field matmul with the inverted Vandermonde recovers the
        # coefficients. Replaces the former top_k + gather + d-step scan.
        era_i8 = era.astype(jnp.int8)
        # the log sum is < n*(q-1); stay in native int32 lanes when that
        # fits (every FEC symbol field)
        sum_dt = jnp.int32 if n * (q - 1) < 2**31 else jnp.int64
        logsum = None
        for i, plane in enumerate(LT_planes):
            s = int8_matmul(era_i8, jnp.asarray(plane))
            term = s.astype(sum_dt) << (7 * i)
            logsum = term if logsum is None else logsum + term
        e_red = logsum % (q - 1)  # (B, d)
        gvals = ops._pow_ladder(
            ops.from_int_scalar(g_int), e_red.astype(jnp.uint64), nbits=g_nbits
        ).astype(dt)
        # exact zeros where the erased position's factor vanishes at z_k
        zk = [k for k in range(1, d) if zero_j[k] >= 0]
        if zk:
            zjs = np.array([zero_j[k] for k in zk])
            vanish = era[:, zjs]  # (B, |zk|) static-index gather of columns
            gvals = gvals.at[:, np.array(zk)].set(
                jnp.where(vanish, jnp.zeros_like(vanish, dtype=dt), gvals[:, np.array(zk)])
            )
        gvals = gvals.at[:, 0].set(jnp.ones((B,), dt))  # Gamma(0) = 1 always
        gamma = fmatmul(gvals, Vinv_T)  # (B, d) ascending coefficients

        # 3. modified syndromes S' = Gamma * S mod x^(d-1)
        Sp = conv_trunc(gamma, S, nroots)  # (B, d-1)

        # 4. BM on S'[u:]: the scan starts at per-row offset u directly
        #    (no row shift — the former take_along_axis was the erasure
        #    path's only gather).
        C, v = berlekamp_massey(Sp, u, B)

        fail = fail | (2 * v + u > nroots)

        # 5. Lambda_total = Gamma * Lambda  (C holds Lambda ascending, deg <= t)
        lam_total = conv_trunc(gamma, C, d)  # (B, d)

        return finish(received, r_z, lam_total, Sp, C, v, u, fail)

    @jax.jit
    def decode_no_erasures(received):
        """Erasure-free specialization: Gamma = 1, S' = S, u = 0 — the scan
        over erasure positions and both Gamma convolutions drop out."""
        B = received.shape[0]
        r = jnp.flip(received, axis=1).astype(dt)
        S = fmatmul(r, W)
        u = jnp.zeros((B,), dtype=jnp.int32)
        C, v = berlekamp_massey(S, u, B)
        fail = 2 * v > nroots
        return finish(received, r, C, S, C, v, u, fail)  # Lambda_total = C (d wide)

    def finish(received, r_z, lam_total, Sp, C, v, u, fail):
        # 6. Chien search over design_n positions
        vals = fmatmul(lam_total, CH.T)  # (B, design_n)
        root = vals == 0
        if design_n > n:
            fail = fail | jnp.any(root[:, n:], axis=1)
        root_n = root[:, :n]
        v_total = jnp.sum(root_n, axis=1).astype(jnp.int32)
        fail = fail | (v_total != v + u)

        # 7. Omega' = Lambda * S' mod x^(d-1)
        omega = conv_trunc(C, Sp, nroots)  # (B, d-1)

        # 8. derivative of Lambda_total: coeff j-1 gets (j mod p) * lam_total[j]
        jmodp = jnp.asarray((np.arange(1, d) % p_char).astype(np.int64)).astype(dt)
        lam_prime = ops.multiply(lam_total[:, 1:], jmodp[None, :])  # (B, d-1)

        # 9. Forney at every position i < n (masked by root_n):
        #    num = Omega'(a^-i), den = Lambda_total'(a^-i)
        CHn = CH[:n, :nroots]  # (n, d-1) powers of a^-i
        num = fmatmul(omega, CHn.T)   # (B, n)
        den = fmatmul(lam_prime, CHn.T)
        fail = fail | jnp.any(root_n & (den == 0), axis=1)
        FPd = jnp.asarray(FP).astype(dt)
        E = ops.multiply(ops.multiply(num, ops.reciprocal(den)), FPd[None, :])
        E = ops.negative(E)
        E = jnp.where(root_n, E, jnp.zeros_like(E))

        # 10. corrected = r_z - E (values lie in the base field on success)
        corrected = ops.subtract(r_z, E)
        corrected = jnp.flip(corrected, axis=1)  # back to descending

        ok = jnp.logical_not(fail)
        out = jnp.where(ok[:, None], corrected, received.astype(dt))
        n_errors = jnp.where(ok, v, -1).astype(jnp.int64)
        # Clean no-error rows (avoid touching erased-but-consistent values):
        # reference writes the corrected (erasure-zeroed) word on success.
        return out, n_errors

    return decode_with_erasures if with_erasures else decode_no_erasures
