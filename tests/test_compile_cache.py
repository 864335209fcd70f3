"""Compile cache placement: JAX_COMPILATION_CACHE_DIR wins untouched;
without it the cache sits at one fixed, git-ignored path in the
checkout."""
import os

import pytest

from dryv_tpu.utils import compile_cache as cc


@pytest.fixture
def updates(monkeypatch):
    import jax
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    return seen


def test_env_var_is_used_and_nothing_is_set(monkeypatch, updates, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    assert cc.setup_compile_cache() == str(tmp_path)
    assert updates == []


def test_default_is_fixed_path_in_checkout(monkeypatch, updates):
    monkeypatch.delenv(cc.ENV, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert cc.setup_compile_cache() == want
    assert cc.setup_compile_cache() == want          # stable across calls
    assert updates == [("jax_compilation_cache_dir", want)] * 2
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
