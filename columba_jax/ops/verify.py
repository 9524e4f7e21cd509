"""Batched in-text verification: banded semi-global DP over text windows.

Batched analogue of the reference's ``InTextVerificationTask``
(reference: src/indexhelpers.cpp:517-577, src/fmindex/fmindex.cpp:267-310):
candidate text positions from locate are verified by aligning the full
pattern against a text window with a banded DP, free start within the first
2*kb+1 columns and free end (final-row minima = occurrence end positions,
the reference's cluster centers in the final matrix column).

Band parametrization: cell (j, d) holds the edit distance of pattern[0:j]
against window[s:j+d] minimized over allowed starts s in [0, 2kb];
d in [-kb, 3kb] (axis index a = d + kb, width 4kb+1).

kb=0 (Hamming) degenerates to a single diagonal mismatch count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import rank
from columba_jax.search.schedule import INF


# uint32 starts >= NEG_T are wrapped negatives (build caps n at 2^32 - 2^18,
# reads at < 2^17 chars, so legitimate window starts never reach NEG_T).
# Host-side np scalar, NOT jnp: a module-level jnp scalar is a *device*
# array created at import time; every trace would embed it as an MLIR
# constant and lowering's ._value fetch then synchronizes on the device
# transfer stream.
NEG_T = np.uint32(2**32 - 2**17)


def gather_window(index: FMIndex, starts: jax.Array, width: int) -> jax.Array:
    """Text codes (B, width) starting at `starts` (uint32, wrapped-negative
    for starts below 0); out-of-range -> 4.

    Fetches whole 16-char words via row gathers on a 2D view of the packed
    text (one gather per row instead of one per character), then aligns
    the window with word-level selects and bit shifts — no per-element
    fancy gather.
    """
    starts = starts.astype(jnp.uint32)
    n = index.n_arr[0]
    # index.text is (rows, 128) uint32 = 2048 chars per row. Two row
    # gathers + a 16-way group select fetch the window's words (a flat
    # word gather is ROADMAP A1/C1).
    t2d = index.text
    Rr = t2d.shape[0]
    is_neg = starts >= NEG_T
    eff = jnp.where(is_neg, jnp.uint32(0), starts)          # anchor neg at 0
    row = (eff >> 11).astype(jnp.int32)                     # 2048-char rows
    nw_out0 = (width + 15) // 16 + 1
    ngrp = (nw_out0 + 7) // 8 + 1           # 8-word (128-char) groups
    rows2 = jnp.concatenate(
        [t2d[jnp.clip(row, 0, Rr - 1)],
         t2d[jnp.clip(row + 1, 0, Rr - 1)]], axis=1)        # (B, 256)
    grp = ((eff >> 7) & jnp.uint32(15)).astype(jnp.int32)   # group in row
    wvals = rows2[:, 0:8 * ngrp]
    for g in range(1, 16):
        wvals = jnp.where((grp == g)[:, None],
                          rows2[:, 8 * g:8 * (g + ngrp)], wvals)
    B = wvals.shape[0]
    nw_in = wvals.shape[1]
    off = (eff & jnp.uint32(127)).astype(jnp.int32)         # (B,) in [0,127]

    # 1) word-align: rotate out the off>>4 leading words (8-way unrolled
    # select; off < 128 so at most 8 word shifts)
    nw_out = (width + 15) // 16 + 1
    assert nw_out + 7 <= nw_in + 1, (nw_out, nw_in)
    pad = jnp.zeros((B, max(nw_out + 8 - nw_in, 0)), wvals.dtype)
    wpad = jnp.concatenate([wvals, pad], axis=1)
    ws = off >> 4                                           # (B,) in [0,7]
    sel = wpad[:, 0:nw_out]
    for s in range(1, 8):
        sel = jnp.where((ws == s)[:, None], wpad[:, s:s + nw_out], sel)

    # 2) bit-align: shift by the remaining 2*(off & 15) bits, borrowing the
    # high bits of the next word
    r2 = (2 * (off & 15)).astype(jnp.uint32)[:, None]       # (B, 1)
    nxt = jnp.concatenate(
        [sel[:, 1:], jnp.zeros((B, 1), sel.dtype)], axis=1)
    shifted = jnp.where(
        r2 == 0, sel, (sel >> r2) | (nxt << (jnp.uint32(32) - r2)))

    # 3) unpack the aligned words and take the first `width` chars
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    chars = ((shifted[..., None] >> shifts) & 3).astype(jnp.int32)
    codes = chars.reshape(B, -1)[:, :width]
    # 4) negative starts: `eff` anchored the window at text pos 0, so roll
    # the content RIGHT by |start| to put text[start+j] at column j (window
    # starts go only kb below 0; unrolled small-shift selects). Without
    # this, occurrences within kb of the text start score against a
    # shifted window and are LOST.
    neg = jnp.where(is_neg, jnp.uint32(0) - starts,
                    jnp.uint32(0)).astype(jnp.int32)        # (B,) |start|
    max_neg = int(min(width - 1, 32))
    for s in range(1, max_neg + 1):
        rolled = jnp.concatenate(
            [jnp.full((B, s), 4, codes.dtype), codes[:, :-s]], axis=1)
        codes = jnp.where((neg == s)[:, None], rolled, codes)
    # positions wrap in uint32: anything below 0 or >= n lands outside [0,n)
    pos = starts[:, None] + jnp.arange(width, dtype=jnp.int32).astype(
        jnp.uint32)[None, :]
    inb = pos < n
    return jnp.where(inb, codes, 4)


def verify_window(
    index: FMIndex,
    patterns: jax.Array,
    rid: jax.Array,
    window_start: jax.Array,
    kb: int,
) -> jax.Array:
    """Final DP row for each candidate.

    patterns: (R, m) read codes; rid: (B,) pattern row per candidate;
    window_start: (B,) text position of window column 0 (= estimated
    pattern start - kb).
    Returns (B, 4kb+1) int32: ed of alignments ending at text position
    window_start + m + (a - kb) for axis index a.
    """
    m = patterns.shape[1]
    bw = 4 * kb + 1
    W = m + 3 * kb + 1
    win = gather_window(index, window_start, W)  # (B, W)
    # pad kb invalid cols in front so row j's diag chars are a static slice
    B = win.shape[0]
    winp = jnp.concatenate(
        [jnp.full((B, kb), 4, win.dtype), win], axis=1
    )  # (B, W + kb)

    d0 = jnp.full((B, bw), INF, jnp.int32)
    d0 = d0.at[:, kb:3 * kb + 1].set(0)  # starts s in [0, 2kb]

    pat = patterns[rid]  # (B, m)

    def one_row(D, pc, wc):
        # diag chars: window cols (j+1)+d-1 = j+d for d in [-kb,3kb]
        # -> winp index j+d+kb = j .. j+4kb  (slice width bw at offset j)
        mis = jnp.where(wc == pc[:, None], 0, 1)
        mis = jnp.where((wc > 3) | (pc[:, None] > 3), 1, mis)  # N mismatches
        diag = D + mis
        up = jnp.concatenate(
            [D[:, 1:], jnp.full((B, 1), INF, jnp.int32)], axis=1
        ) + 1
        nl = jnp.minimum(diag, up)
        if kb > 0:
            d = nl[:, 0:1]
            cols = [d]
            for a in range(1, bw):
                d = jnp.minimum(nl[:, a:a + 1], d + 1)
                cols.append(d)
            nd = jnp.concatenate(cols, axis=1)
        else:
            nd = nl
        return jnp.minimum(nd, INF)

    # unroll U rows per scan step: the per-iteration dispatch overhead of a
    # 100-step scan over small (B, bw) tensors otherwise dominates
    U = next(u for u in (4, 2, 1) if m % u == 0)

    def row_block(carry, j0):
        D = carry
        pcs = jax.lax.dynamic_slice_in_dim(pat, j0, U, axis=1)     # (B, U)
        wcs = jax.lax.dynamic_slice_in_dim(winp, j0, bw + U - 1, axis=1)
        for u in range(U):
            D = one_row(D, pcs[:, u], wcs[:, u:u + bw])
        return D, None

    D, _ = jax.lax.scan(row_block, d0, jnp.arange(0, m, U))
    return D
