"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else
<checkout>/.jax_cache, through the one helper the entry points call."""

import os

import jax

from speaker_recognition.utils import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_unset_falls_back_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(CHECKOUT, ".jax_cache")
    assert compile_cache.CHECKOUT == CHECKOUT


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = compile_cache.enable()
        assert path == os.path.join(CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gitignore_lists_default_cache():
    with open(os.path.join(CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
