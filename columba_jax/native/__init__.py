"""Native (C++) host components, loaded via ctypes.

Compiled lazily with g++ on first use; artifacts are cached next to the
sources. Pure-numpy fallbacks exist for every native entry point so the
package works even without a toolchain; a library that fails to build or
load says so with a RuntimeWarning, since the fallbacks are many times
slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _compile(name: str, sources: list[str], extra_flags: list[str] | None = None) -> str | None:
    """Compile sources into <name>.so next to this file; return the path."""
    so_path = os.path.join(_HERE, f"lib{name}.so")
    src_paths = [os.path.join(_HERE, s) for s in sources]
    if os.path.exists(so_path) and all(
        os.path.getmtime(so_path) >= os.path.getmtime(s) for s in src_paths
    ):
        return so_path
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", so_path, *src_paths, *(extra_flags or [])]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except subprocess.CalledProcessError as e:
        _warn(name, e.stderr.decode(errors="replace")[-2000:])
        return None
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        _warn(name, str(e))
        return None
    return so_path


def _warn(name: str, why: str) -> None:
    warnings.warn(f"native library {name!r} unavailable, using the "
                  f"pure-Python fallback: {why}", RuntimeWarning,
                  stacklevel=3)


def load(name: str, sources: list[str]) -> ctypes.CDLL | None:
    """Load (compiling if needed) a native library; None if unavailable.

    COLUMBA_JAX_NO_NATIVE=1 disables all native components (callers fall
    back to their pure-Python paths)."""
    if os.environ.get("COLUMBA_JAX_NO_NATIVE"):
        return None
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so_path = _compile(name, sources)
        lib = None
        if so_path is not None:
            try:
                lib = ctypes.CDLL(so_path)
            except OSError as e:
                _warn(name, str(e))
                lib = None
        _LIBS[name] = lib
        return lib
