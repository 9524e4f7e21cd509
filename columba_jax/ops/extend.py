"""Batched bidirectional SA-interval extension.

Batched replacement for the reference's per-node character extension
(reference: src/fmindex/fmindex.cpp:137-211 ``findRangesWithExtraChar
Backward/Forward``): one vectorized step extends every node of a frontier by
all four characters at once. The two occ gathers at a node's active-interval
endpoints produce occ for all 4 characters, from which all 4 children's
range pairs follow arithmetically (the reference computes the synchronized
reverse range from cumulative occ the same way).

Direction handling: dir==0 extends backward (prepend char; queries fwd BWT),
dir==1 extends forward (append char; queries rev BWT). With the concatenated
BWT/occ layout (see index.fmindex) direction is a block-row offset, so
frontiers may freely mix directions.

Ranges are **uint32** (genomes to ~4.29 Gbp on one index; the reference's
64-bit length_t analogue, src/definitions.h:69-75): all interval arithmetic
here is add/subtract of non-negative in-range values, so unsigned wrap never
occurs on live lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import rank


def _occ_dir(index: FMIndex, pos: jax.Array, dirs: jax.Array):
    """occ for all 4 chars at `pos` in the BWT selected by `dirs`.

    Returns (occ (...,4) uint32 with '$' slot removed, dollar count (...,)).
    """
    # direction selects the fwd or rev half of the concatenated occ table —
    # a BLOCK-ROW offset into the gather, not a position shift (positions
    # must stay < 2^32)
    blk_extra = dirs.astype(jnp.int32) * index.blocks
    raw = rank.occ_all(index.occ_fused, pos, blk_extra)
    # select, don't gather: tiny-table gathers by traced index are slow
    dollar_row = jnp.where(dirs == 0, index.dollar[0], index.dollar[1])
    d = rank.cnt_dollar(dollar_row, pos)
    raw = raw.at[..., 0].add(-d)  # uint32 wrap-safe: occ[0] >= d always
    return raw, d


def extend_all(index, ranges: jax.Array, dirs: jax.Array) -> jax.Array:
    """Extend every node by all 4 characters.

    ranges: (..., 4) uint32 [f_lo, f_hi, r_lo, r_hi); dirs: (...,) int32.
    Returns (..., 4, 4): child range for chars A,C,G,T. Empty children have
    hi <= lo. RLC indexes use 8-wide ranges with run hints (ops/bextend).
    """
    if not isinstance(index, FMIndex):
        from columba_jax.ops import bextend

        return bextend.extend_all(index, ranges, dirs)
    ranges = ranges.astype(jnp.uint32)
    f_lo, f_hi, r_lo, r_hi = (ranges[..., i] for i in range(4))
    bwd = dirs == 0
    a_lo = jnp.where(bwd, f_lo, r_lo)
    a_hi = jnp.where(bwd, f_hi, r_hi)
    b_lo = jnp.where(bwd, r_lo, f_lo)

    # ONE fused gather for both interval endpoints: a single 2L-row gather
    # runs at a higher rows/s than two L-row gathers (issue-rate-bound,
    # tools/gather_bench.py)
    lead = a_lo.shape
    pos2 = jnp.concatenate([a_lo.reshape(-1), a_hi.reshape(-1)])
    dirs2 = jnp.concatenate([jnp.broadcast_to(dirs, lead).reshape(-1)] * 2)
    occ2, d2 = _occ_dir(index, pos2, dirs2)
    half = pos2.shape[0] // 2
    occ_lo = occ2[:half].reshape(*lead, 4)
    occ_hi = occ2[half:].reshape(*lead, 4)
    d_lo = d2[:half].reshape(lead)
    d_hi = d2[half:].reshape(lead)

    counts = index.counts  # (4,) uint32
    new_a_lo = counts + occ_lo          # (..., 4)
    new_a_hi = counts + occ_hi
    width = new_a_hi - new_a_lo

    # chars-smaller-than-c in bwt[a_lo:a_hi): '$' + exclusive cumsum of occ
    cum_lo = jnp.cumsum(occ_lo, axis=-1) - occ_lo + d_lo[..., None]
    cum_hi = jnp.cumsum(occ_hi, axis=-1) - occ_hi + d_hi[..., None]
    new_b_lo = b_lo[..., None] + (cum_hi - cum_lo)
    new_b_hi = new_b_lo + width

    new_f_lo = jnp.where(bwd[..., None], new_a_lo, new_b_lo)
    new_f_hi = jnp.where(bwd[..., None], new_a_hi, new_b_hi)
    new_r_lo = jnp.where(bwd[..., None], new_b_lo, new_a_lo)
    new_r_hi = jnp.where(bwd[..., None], new_r_lo + width, new_a_hi)
    return jnp.stack([new_f_lo, new_f_hi, new_r_lo, new_r_hi], axis=-1)


def extend_char(
    index, ranges: jax.Array, chars: jax.Array, dirs: jax.Array
) -> jax.Array:
    """Extend every node by its own single character (exact matching step).

    chars: (...,) int32 in 0..3; char 4 (N) yields an empty range.
    Returns (..., 4) child ranges.
    """
    if not isinstance(index, FMIndex):
        from columba_jax.ops import bextend

        return bextend.extend_char(index, ranges, chars, dirs)
    all4 = extend_all(index, ranges, dirs)  # (..., 4, 4)
    safe = jnp.clip(chars, 0, 3).astype(jnp.int32)
    # unrolled selects, not a take_along_axis fancy-index gather
    child = all4[..., 0, :]
    for c in range(1, 4):
        child = jnp.where((safe == c)[..., None], all4[..., c, :], child)
    # N never matches: empty range
    bad = (chars > 3)[..., None]
    return jnp.where(bad, jnp.zeros_like(child), child)


def exact_match(
    index,
    patterns: jax.Array,
    lengths: jax.Array | None = None,
) -> jax.Array:
    """Exact backward match of fixed-width patterns (B, m) int32 codes.

    Matches pattern[m-1], pattern[m-2], ... (backward search). Positions with
    code > 3 beyond `lengths` are skipped (treated as padding); codes > 3
    inside the pattern produce empty ranges.
    Returns (B, 4) final ranges.
    """
    B, m = patterns.shape
    if lengths is None:
        lengths = jnp.full((B,), m, dtype=jnp.int32)
    ranges = index.full_range((B,))
    dirs = jnp.zeros((B,), dtype=jnp.int32)

    def body(i, rs):
        # i-th step matches pattern char at position (lengths-1-i)
        j = lengths - 1 - i
        active = j >= 0
        c = patterns[jnp.arange(B), jnp.clip(j, 0, m - 1)]
        new = extend_char(index, rs, c, dirs)
        return jnp.where(active[..., None], new, rs)

    return jax.lax.fori_loop(0, m, body, ranges)
