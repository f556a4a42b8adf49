"""Multi-device sharded NTT tests (8-device virtual CPU mesh)."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]).reshape(8), ("x",))


def test_sharded_ntt_prime(mesh):
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_fft

    F = g.GF(3 * 2**30 + 1)
    x = F.Random(2**12, seed=5)
    X = sharded_fft(F, x, mesh, "x")
    assert np.array_equal(np.asarray(X), np.asarray(field_fft(x)))
    xi = sharded_fft(F, X, mesh, "x", inverse=True)
    assert np.array_equal(np.asarray(xi), np.asarray(x))


def test_sharded_ntt_goldilocks(mesh):
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_fft

    F = g.GF(2**64 - 2**32 + 1)
    x = F.Random(1024, seed=6)
    X = sharded_fft(F, x, mesh, "x")
    assert np.array_equal(
        np.asarray(X, dtype=object), np.asarray(field_fft(x), dtype=object)
    )


def test_sharded_ntt_bls12_381(mesh):
    """Config 5 groundwork: NTT over the BLS12-381 scalar field (16 limbs)."""
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_fft

    r = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    F = g.GF(r, primitive_element=7, verify=False)
    assert F._meta.storage_width == 16
    x = F.Random(256, seed=7)
    X = sharded_fft(F, x, mesh, "x")
    assert np.array_equal(
        np.asarray(X, dtype=object), np.asarray(field_fft(x), dtype=object)
    )
    xi = sharded_fft(F, X, mesh, "x", inverse=True)
    assert np.array_equal(np.asarray(xi, dtype=object), np.asarray(x, dtype=object))


def test_sharded_matches_batch_of_sizes(mesh):
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_fft

    F = g.GF(257)
    for N in (64, 128, 256):
        x = F.Random(N, seed=N)
        X = sharded_fft(F, x, mesh, "x")
        assert np.array_equal(np.asarray(X), np.asarray(field_fft(x)))


def test_sharded_ntt_non_dsquared_fallback(mesh):
    """D | N but D^2 does not divide N: the replicated all_gather fallback
    must produce the same transform."""
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_fft

    F = g.GF(257)
    # N = 8 * 4 = 32: divisible by D=8 once, not by 64
    x = F.Random(32, seed=11)
    X = sharded_fft(F, x, mesh, "x")
    assert np.array_equal(np.asarray(X), np.asarray(field_fft(x)))
    xi = sharded_fft(F, X, mesh, "x", inverse=True)
    assert np.array_equal(np.asarray(xi), np.asarray(x))


def test_sharded_batched_ntt(mesh):
    """Batch axis sharded over the mesh, transform axis local."""
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_batched_fft

    F = g.GF(3 * 2**30 + 1)
    x = F.Random((16, 256), seed=12)
    X = sharded_batched_fft(F, x, mesh, "x")
    ref = np.stack([np.asarray(field_fft(x[i])) for i in range(16)])
    assert np.array_equal(np.asarray(X), ref)
    xi = sharded_batched_fft(F, X, mesh, "x", inverse=True)
    assert np.array_equal(np.asarray(xi), np.asarray(x))


def test_sharded_batched_ntt_goldilocks(mesh):
    import galois_tpu as g
    from galois_tpu.ops._ntt import field_fft
    from galois_tpu.parallel._ntt_sharded import sharded_batched_fft

    F = g.GF(2**64 - 2**32 + 1)
    x = F.Random((8, 128), seed=13)
    X = sharded_batched_fft(F, x, mesh, "x")
    ref = np.stack([np.asarray(field_fft(x[i]), dtype=object) for i in range(8)])
    assert np.array_equal(np.asarray(X, dtype=object), ref)


def test_sharded_decode_rs_and_bch(mesh):
    """Codeword-axis-sharded decode matches the single-device decode and
    keeps the batch sharded on the mesh."""
    import jax
    import numpy as np

    import galois_tpu as g
    from galois_tpu.parallel import sharded_decode

    rs = g.ReedSolomon(15, 11)
    B = 16
    m = rs.field.Random((B, 11), seed=7)
    cw = np.asarray(rs.encode(m), dtype=np.int64)
    cw[:, 1] ^= 9; cw[:, 8] ^= 4
    dec, nerr = sharded_decode(rs, cw, mesh, "x", output="message")
    assert np.array_equal(np.asarray(dec), np.asarray(m))
    assert all(int(e) == 2 for e in np.asarray(nerr))
    assert "x" in str(dec._data.sharding.spec)

    bch = g.BCH(15, 7)
    mb = bch.field.Random((8, 7), seed=8)
    cb = np.asarray(bch.encode(mb), dtype=np.int64)
    cb[:, 0] ^= 1; cb[:, 13] ^= 1
    db, _ = sharded_decode(bch, cb, mesh, "x", output="message")
    assert np.array_equal(np.asarray(db), np.asarray(mb))


def test_sharded_decode_erasures(mesh):
    """Erasure masks shard alongside the batch; results match code.decode."""
    import numpy as np

    import galois_tpu as g
    from galois_tpu.parallel import sharded_decode

    rs = g.ReedSolomon(15, 9)
    m = rs.field.Random((8, 9), seed=3)
    cw = np.asarray(rs.encode(m), dtype=np.int64)
    cw[:, 1] ^= 3
    era = np.zeros_like(cw, dtype=bool)
    era[:, 4] = True
    cw[:, 4] = 0
    dec, ne = sharded_decode(rs, cw, mesh, "x", output="message", erasures=era)
    ref, ne_ref = rs.decode(rs.field(cw), erasures=era, errors=True)
    assert np.array_equal(np.asarray(dec), np.asarray(m))
    assert np.array_equal(np.asarray(dec), np.asarray(ref))
    assert np.array_equal(np.asarray(ne), np.asarray(ne_ref))
