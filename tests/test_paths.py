"""The one implementation choice (ops/paths.py) and the compile-cache
helper (utils/compile_cache.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.ops import paths
from rtsdr_tpu.ops.coeffs import lowpass_taps
from rtsdr_tpu.ops.fir import (
    _conv1d_valid,
    _conv1d_valid_matmul,
    _conv1d_valid_xla,
)
from rtsdr_tpu.utils import compile_cache


@pytest.mark.parametrize("op,dtype,want", [
    ("fir", jnp.float32, "matmul"),
    ("fir", jnp.float64, "conv"),
    ("resample", jnp.float32, "polyphase"),
    ("resample", jnp.float64, "dilated"),
    ("pll", jnp.float64, "scan"),
])
def test_choice_by_dtype(op, dtype, want):
    assert paths.choose(op, dtype) == want


@pytest.mark.parametrize("backend,want", [("gpu", "kernel"), ("cpu", "scan")])
def test_pll_platform_rule(monkeypatch, backend, want):
    """The one platform rule: the float32 PLL kernel only on the GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert paths.choose("pll", jnp.float32) == want


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        paths.choose("ingest", jnp.float32)


@pytest.mark.parametrize("dtype,impl", [
    (jnp.float32, _conv1d_valid_matmul),
    (jnp.float64, _conv1d_valid_xla),
])
def test_fir_runs_the_chosen_path(rng, dtype, impl):
    h = jnp.asarray(lowpass_taps(240e3, 16e3, 151), dtype)
    x = jnp.asarray(rng.standard_normal((2, 2000)), dtype)
    np.testing.assert_array_equal(np.asarray(_conv1d_valid(x, h, 5)),
                                  np.asarray(impl(x, h, 5)))


def test_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, no other cache set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = compile_cache.DEFAULT_DIR.parent
    assert path == str(root / ".jax_cache")
    assert (root / "rtsdr_tpu").is_dir()


def test_cache_dir_is_gitignored():
    root = compile_cache.DEFAULT_DIR.parent
    ignored = (root / ".gitignore").read_text().split()
    assert compile_cache.DEFAULT_DIR.name + "/" in ignored


@pytest.mark.parametrize("stride,taps,want", [
    (1, 151, 128),     # IF band-pass bank: taps/stride
    (5, 151, 32),      # stereo LPF decimate-by-5: taps/stride
    (10, 151, 32),     # RF decimate-by-10: the 32-output floor
    (80, 3001, 32),
])
def test_block_rule(stride, taps, want):
    from rtsdr_tpu.ops.fir import _block_for_stride

    assert _block_for_stride(stride, taps) == want


def test_pll_unknown_impl_raises():
    from rtsdr_tpu.ops.pll import pll, pll_init

    with pytest.raises(ValueError, match="impl"):
        pll(jnp.zeros((2, 96), jnp.float32), pll_init((2,)), freq=19e3,
            fs=240e3, impl="pallas")
