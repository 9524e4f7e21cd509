"""Suffix-array construction (host side).

Two implementations:
  - native C++ SA-IS (columba_jax/native/sais.cpp), the fast path — the role
    libsais/divsufsort play in the reference build
    (reference: src/buildindex.cpp:479-538);
  - a numpy prefix-doubling fallback (O(n log^2 n), vectorized).

Both operate on the *sentinel-free* text; a virtual smallest sentinel at
position n is assumed (i.e. shorter suffixes sort before longer ones on ties),
matching the semantics of a text terminated by a unique smallest ``$``.
The caller appends the explicit ``$`` row itself (see index.build).
"""

from __future__ import annotations

import ctypes

import numpy as np

from columba_jax import native


def suffix_array(text_codes: np.ndarray, method: str = "auto") -> np.ndarray:
    """Suffix array (n entries) of text_codes (uint8, no sentinel).

    Returned dtype is uint32 when the native kernel handled it (n < 2^32-1)
    and int64 otherwise — callers treat values as non-negative row indices.
    """
    text_codes = np.ascontiguousarray(text_codes, dtype=np.uint8)
    n = len(text_codes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if method in ("auto", "native"):
        sa = _sais_native(text_codes)
        if sa is not None:
            return sa
        if method == "native":
            raise RuntimeError("native sais unavailable")
    return _prefix_doubling(text_codes)


def _sais_native(text_codes: np.ndarray) -> np.ndarray | None:
    lib = native.load("sais", ["sais.cpp"])
    if lib is None:
        return None
    n = len(text_codes)
    if n < 2**32 - 1 and hasattr(lib, "sais_u8_u32"):
        sa = np.empty(n, dtype=np.uint32)
        fn = lib.sais_u8_u32
        ptr = sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    else:
        sa = np.empty(n, dtype=np.int64)
        fn = lib.sais_u8
        ptr = sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    fn.restype = ctypes.c_int
    rc = fn(
        text_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        ptr,
    )
    if rc != 0:
        return None
    return sa


def _prefix_doubling(text_codes: np.ndarray) -> np.ndarray:
    """Manber-Myers prefix doubling with numpy lexsort."""
    n = len(text_codes)
    rank = text_codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    rank = _rerank(rank[sa], sa, n)
    h = 1
    while h < n:
        # key = (rank[i], rank[i+h]) with rank[i+h] = -1 past the end
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - h] = rank[h:]
        order = np.lexsort((rank2, rank))
        sa = order
        combined = rank[sa] * (n + 1) + (rank2[sa] + 1)
        rank = _rerank(combined, sa, n)
        if rank[sa[-1]] == n - 1:
            break
        h *= 2
    return sa


def _rerank(sorted_keys: np.ndarray, sa: np.ndarray, n: int) -> np.ndarray:
    new_rank_sorted = np.zeros(n, dtype=np.int64)
    np.cumsum(sorted_keys[1:] != sorted_keys[:-1], out=new_rank_sorted[1:])
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = new_rank_sorted
    return rank


def naive_suffix_array(text_codes: np.ndarray) -> np.ndarray:
    """O(n^2 log n) reference for tests."""
    t = bytes(np.asarray(text_codes, dtype=np.uint8))
    return np.array(sorted(range(len(t)), key=lambda i: t[i:]), dtype=np.int64)
