"""Persistent compile cache: where it lives, and that it stays off on CPU."""

import os

import jax

from columba_jax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_honours_jax_compilation_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_off_on_cpu(monkeypatch):
    monkeypatch.delenv("COLUMBA_JAX_NO_COMPILE_CACHE", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert compile_cache.enable() is None
    assert jax.config.jax_compilation_cache_dir == before


def _cache(tmp_path, max_size):
    from jax._src import lru_cache

    compile_cache._patch_atomic_put()
    return lru_cache.LRUCache(str(tmp_path), max_size=max_size)


def test_atomic_put_writes_whole_entries(tmp_path):
    c = _cache(tmp_path, -1)
    c.put("a", b"x" * 100)
    c.put("a", b"y" * 100)           # an existing key is left alone
    assert c.get("a") == b"x" * 100
    assert sorted(os.listdir(tmp_path)) == ["a-cache"]


def test_atomic_put_keeps_lru_bookkeeping(tmp_path):
    """With a size limit, every entry has its access-time file and old
    entries are evicted, so jax's own writes keep working."""
    c = _cache(tmp_path, 250)
    for k in "abc":
        c.put(k, k.encode() * 100)
    names = set(os.listdir(tmp_path)) - {".lockfile"}
    assert names == {"b-cache", "b-atime", "c-cache", "c-atime"}
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_atomic_put_heals_entries_without_atime(tmp_path):
    (tmp_path / "old-cache").write_bytes(b"o" * 100)   # no -atime file
    c = _cache(tmp_path, 10_000)
    c.put("new", b"n" * 100)
    names = set(os.listdir(tmp_path)) - {".lockfile"}
    assert names == {"old-cache", "old-atime", "new-cache", "new-atime"}
