"""chip_smoke.py at tiny sizes: its phases and exact references on the
CPU, its refusal to run without a GPU, and its compile-cache rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import galois_tpu as gt


def test_dots_phase_tiny():
    chip_smoke.phase_dots(ks=(1, 5, 17, 64), shapes=((1, 8, 6), (3, 4, 5)))


def test_dot_sweep_reports_a_wrong_dot():
    def off_by_one(a, b):
        out = jnp.matmul(a, b, preferred_element_type=jnp.int32)
        return out + (a.shape[-1] == 5)

    failures, kinds = chip_smoke.int8_dot_sweep(off_by_one, ks=(4, 5), shapes=((1, 3, 2), (2, 3, 2)))
    assert failures == [(5, 1, 3, 2), (5, 2, 3, 2)]
    assert set(kinds) == {4, 5}


@pytest.mark.parametrize("text, kind", [
    ('custom_call_target="__cublas$lt$matmul"', "cublas"),
    ('"kind":"__triton_gemm"', "triton"),
    ("fusion(...), kind=kLoop", "fusion"),
])
def test_dot_kind(text, kind):
    assert chip_smoke.dot_kind(text) == kind


def test_fields_phase_tiny():
    chip_smoke.phase_fields(log_n=12, log_n_wide=10)


def test_linalg_phase_tiny():
    chip_smoke.phase_linalg(n8=16, batch8=3, n31=32, n_inv=8)


def test_ntt_phase_tiny():
    chip_smoke.phase_ntt(cases=((8, 2), (12, 2)), log_gold=8, bls_logs=(6,))


def test_fec_phase_tiny():
    chip_smoke.phase_fec(n_rs=64, n_bch=32)


def test_sharded_phase_tiny_on_virtual_mesh():
    assert len(jax.devices()) >= 4
    chip_smoke.phase_sharded(n_dev=4, log_n=8, log_bls=6, batch=8, log_batch=8, n_rs=32)


def test_report_raises_on_mismatch(capsys):
    with pytest.raises(AssertionError):
        chip_smoke.report("x", "mismatch", 0.0, 0.0, False)
    assert "exact=FAIL" in capsys.readouterr().out


def test_direct_dft_reference_detects_a_wrong_output():
    p = 257
    x = np.arange(16, dtype=np.uint64)
    X = np.asarray(np.fft.fft(gt.GF(p)(x.astype(np.int64))))
    ks = np.arange(16)
    assert chip_smoke._direct_dft_ok(x, X, p, ks)
    X[3] = (X[3] + 1) % p
    assert not chip_smoke._direct_dft_ok(x, X, p, ks)


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_cache_dir_follows_the_variable():
    assert chip_smoke.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}) == "/some/cache"


def test_cache_dir_defaults_to_fixed_path_in_checkout(monkeypatch):
    want = str(chip_smoke.ROOT / ".jax_cache")
    assert chip_smoke.compile_cache_dir({}) == want
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert chip_smoke.use_compile_cache() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_set_by_variable_is_left_to_jax(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "/from/env")  # what JAX reads at start-up
        assert chip_smoke.use_compile_cache() == "/from/env"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu_device):
    """The smoke phases at small sizes, compiled for the card."""
    with jax.default_device(gpu_device):
        chip_smoke.phase_fields(log_n=16, log_n_wide=14)
        chip_smoke.phase_linalg(n8=64, batch8=4, n31=128, n_inv=32)
        chip_smoke.phase_ntt(cases=((12, 4),), log_gold=12, bls_logs=(10,))
        chip_smoke.phase_fec(n_rs=256, n_bch=128)
