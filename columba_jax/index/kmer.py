"""Dense k-mer seed table: bidirectional SA ranges of every k-mer.

Batched replacement for the reference's k-mer hash table
(reference: src/indexinterface.cpp:294-335 ``populateTable``, built by DFS
into a parallel hash map): here the table is **direct-addressed** — a dense
(4^K, 4) int32 tensor of SARangePairs indexed by the 2-bit-packed k-mer —
built on device by K lockstep steps of batched backward extension over all
4^K patterns at once. Lookup is a single gather, which is exactly what the
frontier initialization and (later) dynamic partitioning want.

Code convention: code(P) = sum_j P[j] * 4^(K-1-j) (first char = most
significant digits).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import extend

DEFAULT_K = 10  # reference default k-mer size (src/definitions.h)


def pack_codes(chars: jax.Array) -> jax.Array:
    """(…, K) char codes -> packed int32 k-mer codes; any N -> -1."""
    K = chars.shape[-1]
    weights = 4 ** jnp.arange(K - 1, -1, -1, dtype=jnp.int32)
    code = jnp.sum(jnp.clip(chars, 0, 3).astype(jnp.int32) * weights, axis=-1)
    bad = jnp.any(chars > 3, axis=-1) | jnp.any(chars < 0, axis=-1)
    return jnp.where(bad, -1, code)


def table_k(table) -> int:
    """Recover K from a dense table's row count (4^K rows)."""
    n = int(table.shape[0])
    K = max(1, round(math.log(n, 4)))
    assert 4 ** K == n, f"k-mer table rows {n} not a power of 4"
    return K


@functools.partial(jax.jit, static_argnums=1)
def build_kmer_table(index: FMIndex, K: int = DEFAULT_K) -> jax.Array:
    """(4^K, 4) int32 bidirectional ranges for all K-mers (reference -K,
    default 10; dense direct-addressing caps K at 13 = 1 GiB)."""
    n = 4 ** K
    codes = jnp.arange(n, dtype=jnp.int32)
    ranges = index.full_range((n,))
    dirs = jnp.zeros((n,), dtype=jnp.int32)
    # backward match: last char first -> digit j consumed at step K-1-j
    for step in range(K):
        j = K - 1 - step  # pattern position consumed this step
        chars = (codes >> (2 * (K - 1 - j))) & 3
        ranges = extend.extend_char(index, ranges, chars, dirs)
    return ranges


def build_kmer_table_cached(index: FMIndex, K: int,
                            cache_dir: str) -> jax.Array:
    """Device k-mer table with an on-disk cache in the index directory
    (the table is a pure function of the index + K; rebuilding it on
    device costs a large jit compile per process, the reference instead
    pays populateTable's DFS per process, src/indexinterface.cpp:294-335).
    """
    import os

    import numpy as np

    path = os.path.join(cache_dir, f"kmer{K}.npy")
    if os.path.exists(path):
        try:
            return jax.device_put(np.load(path))
        except (ValueError, OSError):
            pass
    table = build_kmer_table(index, K)
    host = np.asarray(table)
    try:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, host)
        os.replace(tmp, path)
    except OSError:
        pass
    return table


def lookup(table: jax.Array, chars: jax.Array) -> jax.Array:
    """Gather (…, 4) ranges for k-mers given as (…, K) char windows.

    Windows containing N yield empty ranges. Ranges are uint32 (tables
    persisted as int32 by round-1 caches are bit-identical; cast on read).
    """
    code = pack_codes(chars)
    safe = jnp.clip(code, 0, table.shape[0] - 1)
    out = table[safe].astype(jnp.uint32)
    return jnp.where((code >= 0)[..., None], out, jnp.zeros_like(out))
