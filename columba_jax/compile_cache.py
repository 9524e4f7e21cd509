"""Persistent XLA compilation cache.

The frontier executor compiles one program per (read length, scheme, k,
batch size). The reference pays nothing comparable (C++ AOT), so without a
persistent cache every CLI invocation eats the warmup again. Enabling JAX's
disk cache makes the cost once per cache directory instead of once per
process.

Call ``enable()`` before the first jit dispatch (the CLI and bench do).
The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
it itself); otherwise the fixed ``.jax_cache/`` at the root of the checkout.
A fixed path matters: the path is part of every entry's key, so a directory
that moves never hits. Opt out with COLUMBA_JAX_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

_enabled = False

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: JAX_COMPILATION_CACHE_DIR, else the
    checkout's own .jax_cache/."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str | None:
    """Configure jax's persistent compilation cache (idempotent).

    Returns the cache dir, or None when disabled (env opt-out, or the CPU
    backend)."""
    global _enabled
    if os.environ.get("COLUMBA_JAX_NO_COMPILE_CACHE"):
        return None
    path = cache_dir()
    if _enabled:
        return path
    import jax

    if jax.default_backend() == "cpu":
        # XLA:CPU executable serialization segfaults on some of the
        # executor's programs (observed in-suite, jax 0.7 era), and CPU
        # compiles are fast enough that the cache buys little.
        return None

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # JAX's own 1 s compile-time floor: caching every compile (floor 0)
    # measured no faster warm and slower cold on the H100 (PERF.md).
    _patch_atomic_put()
    _enabled = True
    return path


def _patch_atomic_put() -> None:
    """Make jax's on-disk cache writes atomic (tmp file + rename).

    jax's LRUCache.put writes entries with a plain write_bytes; a process
    killed mid-write (timeouts, OOM kills) leaves a TRUNCATED entry. This
    put is jax's own (lock, LRU eviction, access-time file when a size
    limit is set) with the entry written to a temp file and os.replace()d
    into place. The access-time file matters: jax's eviction reads one for
    every entry, and a single entry without one makes every later write
    fail.
    """
    try:
        from jax._src import lru_cache as _lru
    except ImportError:  # pragma: no cover - jax internals moved
        return
    cls = getattr(_lru, "LRUCache", None)
    if cls is None or getattr(cls, "_columba_atomic", False):
        return
    orig_put = cls.put
    cache_sfx = getattr(_lru, "_CACHE_SUFFIX", "-cache")
    atime_sfx = getattr(_lru, "_ATIME_SUFFIX", "-atime")

    def atomic_put(self, key, val):
        import pathlib
        import tempfile
        import time

        path = getattr(self, "path", None)
        evict = getattr(self, "eviction_enabled", False)
        if not key or path is None or (evict and len(val) > self.max_size):
            return orig_put(self, key, val)
        path = pathlib.Path(path)
        if evict:
            self.lock.acquire(timeout=self.lock_timeout_secs)
        try:
            target = path / f"{key}{cache_sfx}"
            if target.exists():
                return
            if evict:
                # entries an earlier version of this put left without an
                # access-time file would make eviction raise on every put
                for p in path.glob(f"*{cache_sfx}"):
                    t = path / (p.name[:-len(cache_sfx)] + atime_sfx)
                    if not t.exists():
                        t.write_bytes(p.stat().st_mtime_ns.to_bytes(
                            8, "little"))
                self._evict_if_needed(additional_size=len(val))
            fd, tmp = tempfile.mkstemp(dir=str(path), suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(val)
                os.replace(tmp, target)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return
            if evict:
                (path / f"{key}{atime_sfx}").write_bytes(
                    time.time_ns().to_bytes(8, "little"))
        finally:
            if evict:
                self.lock.release()

    cls.put = atomic_put
    cls._columba_atomic = True
