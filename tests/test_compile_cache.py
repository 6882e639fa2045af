"""Every entry point shares one compile-cache rule (dindel_tpu/
compile_cache.py): JAX_COMPILATION_CACHE_DIR when set, else a fixed
directory inside the checkout."""

import jax
import pytest

from dindel_tpu import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable("cpu-tests") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "unchanged"


@pytest.mark.parametrize("subdir", ["", "cpu-tests"])
def test_checkout_dir_without_env(monkeypatch, subdir, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable(subdir)
    want = compile_cache.CHECKOUT_CACHE / subdir if subdir \
        else compile_cache.CHECKOUT_CACHE
    assert got == str(want)
    assert jax.config.jax_compilation_cache_dir == got
    assert compile_cache.CHECKOUT_CACHE.parent.joinpath(
        "dindel_tpu").is_dir()
