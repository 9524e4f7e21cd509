"""Core device ops vs naive references: rank, extension, exact match, locate."""

import numpy as np
import pytest

import jax.numpy as jnp

from columba_jax.index.build import build_index_from_codes
from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import extend, locate, rank


def _sa_bwt(codes):
    """SA and BWT of codes+'$' via the (separately validated) fast SA."""
    from columba_jax.index.suffix import suffix_array

    n = len(codes)
    text = np.concatenate([codes.astype(np.int16), [-1]])
    sa = np.empty(n + 1, dtype=np.int64)
    sa[0] = n
    sa[1:] = suffix_array(codes)
    bwt = text[sa - 1]
    return sa, bwt


@pytest.fixture(scope="module")
def setup(small_index):
    genome, arrays = small_index
    fm = FMIndex.from_arrays(arrays)
    sa, bwt = _sa_bwt(genome)
    rsa, rbwt = _sa_bwt(genome[::-1].copy())
    return genome, arrays, fm, sa, bwt, rsa, rbwt


def naive_occ(bwt, c, p):
    return int((bwt[:p] == c).sum())


def test_occ_all(setup, rng):
    genome, arrays, fm, sa, bwt, rsa, rbwt = setup
    n1 = len(genome) + 1
    pos = rng.integers(0, n1 + 1, size=200).astype(np.int32)
    got = np.asarray(rank.occ_all(fm.occ_fused, jnp.asarray(pos)))
    for i, p in enumerate(pos):
        for c in range(4):
            expect = naive_occ(bwt, c, p) + (
                1 if c == 0 and naive_occ(bwt, -1, p) else 0
            )
            assert got[i, c] == expect, (p, c)


def test_rank_bits(setup, rng):
    genome, arrays, fm, sa, bwt, rsa, rbwt = setup
    n1 = len(genome) + 1
    sampled = (sa % arrays.meta["sa_sparseness"]) == 0
    pos = rng.integers(0, n1, size=100).astype(np.int32)
    got = np.asarray(rank.rank_bits(fm.sa_bits, fm.sa_bits_rank, jnp.asarray(pos)))
    expect = np.array([sampled[:p].sum() for p in pos])
    np.testing.assert_array_equal(got, expect)


def _naive_range(sa, text_codes, pattern):
    """SA range of pattern: occurrences found by text scan, mapped to rows."""
    n = len(text_codes)
    m = len(pattern)
    if m == 0:
        return (0, n + 1)
    # all text occurrence start positions
    win = np.lib.stride_tricks.sliding_window_view(text_codes, m)
    starts = set(np.nonzero((win == pattern).all(axis=1))[0].tolist())
    rows = [r for r, s in enumerate(sa) if int(s) in starts]
    if not rows:
        return (0, 0)
    assert rows == list(range(rows[0], rows[-1] + 1)), "range not contiguous"
    return (rows[0], rows[-1] + 1)


def test_exact_match_vs_naive(setup, rng):
    genome, arrays, fm, sa, bwt, rsa, rbwt = setup
    n = len(genome)
    pats = []
    for L in (1, 3, 8, 15):
        for _ in range(5):
            p = int(rng.integers(0, n - L))
            pats.append(genome[p:p + L])
    maxlen = max(len(p) for p in pats)
    B = len(pats)
    mat = np.full((B, maxlen), 5, dtype=np.int32)
    lens = np.zeros(B, dtype=np.int32)
    for i, p in enumerate(pats):
        # right-align? exact_match matches pattern[lengths-1-i]; store left-aligned
        mat[i, : len(p)] = p
        lens[i] = len(p)
    got = np.asarray(extend.exact_match(fm, jnp.asarray(mat), jnp.asarray(lens)))
    for i, p in enumerate(pats):
        lo, hi = _naive_range(sa, genome, p)
        assert (got[i, 0], got[i, 1]) == (lo, hi), f"pattern {i}"
        assert got[i, 3] - got[i, 2] == hi - lo  # synchronized width


def test_bidirectional_consistency(setup, rng):
    """Extending backward then forward == exact range of combined pattern."""
    genome, arrays, fm, sa, bwt, rsa, rbwt = setup
    n = len(genome)
    B = 32
    starts = rng.integers(2, n - 12, size=B)
    # pattern = genome[s:s+6]; match genome[s+2:s+4] backward from full range,
    # then extend forward with genome[s+4], then backward with genome[s+1]
    ranges = fm.full_range((B,))
    dirs0 = jnp.zeros((B,), dtype=jnp.int32)
    dirs1 = jnp.ones((B,), dtype=jnp.int32)
    c = lambda off: jnp.asarray(genome[starts + off].astype(np.int32))
    r = extend.extend_char(fm, ranges, c(3), dirs0)
    r = extend.extend_char(fm, r, c(2), dirs0)
    r = extend.extend_char(fm, r, c(4), dirs1)
    r = extend.extend_char(fm, r, c(1), dirs0)
    got = np.asarray(r)
    for i in range(B):
        s = int(starts[i])
        lo, hi = _naive_range(sa, genome, genome[s + 1:s + 5])
        assert (got[i, 0], got[i, 1]) == (lo, hi), i
        # reverse range: naive range on reversed text of reversed pattern
        rlo, rhi = _naive_range(rsa, genome[::-1].copy(), genome[s + 1:s + 5][::-1])
        assert (got[i, 2], got[i, 3]) == (rlo, rhi), i


def test_locate(setup, rng):
    genome, arrays, fm, sa, bwt, rsa, rbwt = setup
    n1 = len(genome) + 1
    rows = rng.integers(0, n1, size=300).astype(np.int32)
    got = np.asarray(locate.locate_rows(fm, jnp.asarray(rows)))
    np.testing.assert_array_equal(got, sa[rows])
