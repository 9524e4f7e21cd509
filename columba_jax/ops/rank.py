"""Batched rank/occ over 2-bit packed BWT words.

The batched replacement for the reference's interleaved rank9 bitvector
query (reference: src/bitvec.h:356-372 ``BitvecIntl::rank``): a checkpoint
row gather + in-block popcount reduction, vectorized over a frontier of
positions, returning occ for *all four* characters at once (one gather serves
all 4 children of a frontier node).

Layout: BLOCK=128 chars per checkpoint, 8 uint32 words per block.
The '$' row is packed as code 0 (A); callers adjust via `dollar`.

Position dtype: **uint32** end to end — this design's answer to the
reference's 32/64-bit ``length_t`` switch (src/definitions.h:69-75). Genomes
up to ~4.29 Gbp (2^32 - 2^17 guard band) use one index with no widening of
the hot-path words; block indices and in-block offsets always fit int32 and
are cast down right after the shift so the arithmetic that can go negative
(offset - word*16) stays signed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BLOCK = 128
WPB = 8  # words per block

# Python int literals, NOT a device array: a closure-captured jnp array
# indexed in-trace becomes an XLA constant operand of every fusion that
# touches it (ROADMAP C2).
_PAT = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)


def _blk_off(pos: jax.Array):
    """(block index int32, in-block offset int32) of uint32 positions."""
    pos = pos.astype(jnp.uint32)
    blk = (pos >> 7).astype(jnp.int32)      # < 2^25 blocks: int32-safe
    off = (pos & jnp.uint32(127)).astype(jnp.int32)
    return blk, off


def _count4(wvals: jax.Array, mask: jax.Array):
    """Per-char popcounts of masked 2-bit slots -> (..., 4) uint32."""
    out = []
    for c in range(4):
        x = wvals ^ jnp.uint32(_PAT[c])
        hits = (~x) & ((~x) >> 1) & jnp.uint32(0x55555555) & mask
        out.append(jnp.sum(jax.lax.population_count(hits),
                           axis=-1).astype(jnp.uint32))
    return jnp.stack(out, axis=-1)


def _word_mask(off: jax.Array) -> jax.Array:
    """(..., WPB) uint32 masks of the 2r low bits where r = chars of each
    word lying before the in-block offset `off` (int32, 0..127)."""
    r = off[..., None] - 16 * jnp.arange(WPB, dtype=jnp.int32)
    r = jnp.clip(r, 0, 16)
    shift = jnp.minimum(2 * r, 31).astype(jnp.uint32)
    return jnp.where(
        r >= 16,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << shift) - jnp.uint32(1),
    )


def occ_all(fused: jax.Array, pos: jax.Array,
            blk_extra: jax.Array | None = None) -> jax.Array:
    """occ(c, pos) for c in A,C,G,T.

    fused: (blocks, 16) uint32 interleaved rows [4 ckpt | 8 packed words |
    4 pad] (see index.fmindex) — ONE 64B row gather serves the whole query;
    pos: (...,) uint32 positions in [0, rows];
    blk_extra: optional (...,) int32 extra block-row offset (used by the
    concatenated fwd/rev layout to select the direction's table — positions
    themselves stay < 2^32, only the gather row shifts).
    Returns (..., 4) uint32 counts of each code in words[0:pos) — counting
    the '$' slot as code 0 (callers subtract the dollar adjustment).
    """
    blk, off = _blk_off(pos)
    if blk_extra is not None:
        blk = blk + blk_extra.astype(jnp.int32)
    row = fused[blk]  # (..., 16) uint32
    base = row[..., :4]
    wvals = row[..., 4:12]
    return base + _count4(wvals, _word_mask(off))


def occ_all_and_char(fused: jax.Array, pos: jax.Array,
                     blk_extra: jax.Array | None = None):
    """occ_all(pos) plus the 2-bit code AT pos, from one block-row fetch."""
    blk, off = _blk_off(pos)
    if blk_extra is not None:
        blk = blk + blk_extra.astype(jnp.int32)
    row = fused[blk]
    base = row[..., :4]
    wvals = row[..., 4:12]
    occ = base + _count4(wvals, _word_mask(off))
    # decode char at pos: word index (off>>4), slot off&15 (unrolled
    # selects instead of per-lane fancy indexing)
    widx = off >> 4
    w = wvals[..., 0]
    for i in range(1, WPB):
        w = jnp.where(widx == i, wvals[..., i], w)
    char = ((w >> (2 * (off & 15)).astype(jnp.uint32)) & 3).astype(jnp.int32)
    return occ, char


def cnt_dollar(dollar_row: jax.Array, pos: jax.Array) -> jax.Array:
    """Number of '$' in bwt[0:pos) (0 or 1), uint32."""
    return (dollar_row.astype(jnp.uint32)
            < pos.astype(jnp.uint32)).astype(jnp.uint32)


def rank_bits(bits: jax.Array, bits_rank: jax.Array, pos: jax.Array) -> jax.Array:
    """rank1 over a packed marker bitvector (32 bits/word, 128/block).

    bits: (blocks, 4) uint32 rows (shaped at load — an in-program narrow
    reshape would materialize a 32x tile-padded temp, ops/verify.py note).
    Returns uint32 (a dense-SA sampling can have > 2^31 set bits)."""
    blk, off = _blk_off(pos)
    base = bits_rank[blk].astype(jnp.uint32)
    wvals = bits[blk]                 # one 16B row per lane
    r = jnp.clip(off[..., None] - 32 * jnp.arange(4, dtype=jnp.int32), 0, 32)
    shift = jnp.minimum(r, 31).astype(jnp.uint32)
    mask = jnp.where(
        r >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << shift) - jnp.uint32(1)
    )
    cnt = jnp.sum(jax.lax.population_count(wvals & mask),
                  axis=-1).astype(jnp.uint32)
    return base + cnt


def get_bit(bits: jax.Array, pos: jax.Array) -> jax.Array:
    """Marker bit at pos; bits is the (blocks, 4) row layout."""
    pos = pos.astype(jnp.uint32)
    row = bits[(pos >> 7).astype(jnp.int32)]          # (..., 4)
    wi = ((pos >> 5) & jnp.uint32(3)).astype(jnp.int32)
    w = row[..., 0]
    for i in range(1, 4):
        w = jnp.where(wi == i, row[..., i], w)
    return ((w >> (pos & jnp.uint32(31))) & 1).astype(jnp.bool_)


def gather_codes(words: jax.Array, pos: jax.Array) -> jax.Array:
    """Gather single 2-bit codes at positions (no bounds check)."""
    pos = pos.astype(jnp.uint32)
    w = words[(pos >> 4).astype(jnp.int32)]
    return ((w >> (2 * (pos & jnp.uint32(15)))) & 3).astype(jnp.int32)
