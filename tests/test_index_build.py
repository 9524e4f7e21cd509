"""Index construction: SA, BWT, occ checkpoints, packing vs naive refs."""

import numpy as np
import pytest

from columba_jax.core import alphabet
from columba_jax.index.build import (
    build_index_from_codes,
    load_index,
    pack_2bit,
    save_index,
    unpack_2bit,
)
from columba_jax.index.suffix import naive_suffix_array, suffix_array


@pytest.mark.parametrize("n", [1, 2, 10, 257, 1000])
@pytest.mark.parametrize("method", ["native", "numpy"])
def test_suffix_array_matches_naive(n, method, rng):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    if method == "native":
        try:
            sa = suffix_array(codes, method="native")
        except RuntimeError:
            pytest.skip("native sais unavailable")
    else:
        from columba_jax.index.suffix import _prefix_doubling

        sa = _prefix_doubling(codes)
    naive = naive_suffix_array(codes)
    np.testing.assert_array_equal(sa, naive)


def test_suffix_array_repetitive(rng):
    codes = np.tile(np.array([0, 1, 0, 1, 2], dtype=np.uint8), 200)
    np.testing.assert_array_equal(suffix_array(codes), naive_suffix_array(codes))


def test_native_vs_numpy_large(rng):
    codes = rng.integers(0, 4, size=50000).astype(np.uint8)
    try:
        sa_n = suffix_array(codes, method="native")
    except RuntimeError:
        pytest.skip("native sais unavailable")
    from columba_jax.index.suffix import _prefix_doubling

    np.testing.assert_array_equal(sa_n, _prefix_doubling(codes))


def test_pack_unpack_roundtrip(rng):
    codes = rng.integers(0, 4, size=1003).astype(np.uint8)
    np.testing.assert_array_equal(unpack_2bit(pack_2bit(codes), 1003), codes)


def _naive_bwt(codes):
    n = len(codes)
    text = np.concatenate([codes.astype(np.int16), [-1]])  # -1 = '$'
    sa = np.array(
        sorted(range(n + 1), key=lambda i: tuple(text[i:])), dtype=np.int64
    )
    bwt = text[sa - 1]  # sa==0 row -> text[-1] = '$' conveniently
    return sa, bwt


def test_bwt_and_occ(rng):
    codes = rng.integers(0, 4, size=1500).astype(np.uint8)
    idx = build_index_from_codes(codes)
    sa, bwt = _naive_bwt(codes)
    n = len(codes)

    # dollar position
    assert bwt[idx.dollar_fwd] == -1
    # packed bwt matches naive with '$' as code 0
    got = unpack_2bit(idx.bwt, n + 1)
    expect = np.where(bwt == -1, 0, bwt).astype(np.uint8)
    np.testing.assert_array_equal(got, expect)

    # occ checkpoints vs naive cumulative counts
    for b in range(idx.occ.shape[0]):
        p = min(b * 128, n + 1)
        for c in range(4):
            naive_cnt = int((bwt[:p] == c).sum()) + (
                1 if c == 0 and (bwt[:p] == -1).any() else 0
            )  # '$' slot counted as A in packed layout
            assert idx.occ[b, c] == naive_cnt, (b, c)

    # counts = first SA row per char
    first = {c: None for c in range(4)}
    sorted_chars = np.where(bwt[sa.argsort()] is None, 0, 0)  # unused
    # F column = sorted text+'$'
    f_col = np.sort(np.concatenate([codes.astype(np.int16), [-1]]))
    for c in range(4):
        rows = np.nonzero(f_col == c)[0]
        if len(rows):
            assert idx.counts[c] == rows[0]

    # SA samples: walk check
    sampled_rows = np.nonzero((sa % idx.meta["sa_sparseness"]) == 0)[0]
    assert len(idx.sa_samples) == len(sampled_rows)
    np.testing.assert_array_equal(idx.sa_samples, sa[sampled_rows])


def test_save_load_roundtrip(tmp_path, rng):
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    idx = build_index_from_codes(codes)
    save_index(idx, str(tmp_path / "idx"))
    idx2 = load_index(str(tmp_path / "idx"))
    np.testing.assert_array_equal(idx.bwt, idx2.bwt)
    np.testing.assert_array_equal(idx.occ, idx2.occ)
    np.testing.assert_array_equal(idx.sa_samples, idx2.sa_samples)
    assert idx.meta == idx2.meta


def test_preprocess_fasta(tmp_path):
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1 desc\nACGTN\nNNGT\n>chr2\nacgt\n")
    from columba_jax.index.build import preprocess_fasta

    codes, names, starts = preprocess_fasta([str(fa)], seed=1)
    assert names == ["chr1", "chr2"]
    assert list(starts) == [0, 9, 13]
    assert codes.max() <= 3
    # non-N chars preserved
    np.testing.assert_array_equal(codes[:4], alphabet.encode("ACGT"))
    np.testing.assert_array_equal(codes[9:13], alphabet.encode("ACGT"))


@pytest.fixture(scope="module")
def upload_pair(small_index):
    from columba_jax.index.fmindex import FMIndex

    _, arrays = small_index
    return arrays, FMIndex.from_arrays(arrays)


def _fm_host(arrays, field):
    """The host array FMIndex.from_arrays uploads for `field`."""
    from columba_jax.index.fmindex import _pad_reshape4

    u32 = lambda a: np.asarray(a, dtype=np.uint32)  # noqa: E731
    if field == "occ_fused":
        fused = np.zeros((2 * arrays.occ.shape[0], 16), np.uint32)
        fused[:, :4] = np.concatenate([arrays.occ, arrays.rocc])
        fused[:, 4:12] = np.concatenate(
            [arrays.bwt, arrays.rbwt]).reshape(-1, 8)
        return fused
    if field == "text":
        t = u32(arrays.text)
        return np.concatenate(
            [t, np.zeros((-len(t)) % 128 + 128, np.uint32)]).reshape(-1, 128)
    if field == "dollar":
        return u32([arrays.dollar_fwd, arrays.dollar_rev])
    if field == "sa_bits":
        return _pad_reshape4(arrays.sa_bits)
    if field == "n_arr":
        return u32([arrays.n, arrays.n + 1])
    return u32(getattr(arrays, field))


@pytest.mark.parametrize("field", [
    "occ_fused", "counts", "dollar", "text", "sa_samples", "sa_bits",
    "sa_bits_rank", "n_arr",
])
def test_fmindex_upload_matches_host(upload_pair, field):
    """Each device array equals its host array in values, dtype, shape."""
    arrays, index = upload_pair
    dev = np.asarray(getattr(index, field))
    host = _fm_host(arrays, field)
    assert dev.dtype == host.dtype and dev.shape == host.shape
    assert np.array_equal(dev, host)


@pytest.mark.parametrize("field", [
    "fused", "first_row", "text", "sa_stride", "n_arr"])
def test_bmove_upload_matches_host(small_index, field):
    from columba_jax.index.bmove import BMoveIndex, build_bmove_from_codes

    genome, _ = small_index
    arrays = build_bmove_from_codes(genome[:4000])
    index = BMoveIndex.from_arrays(arrays)
    u32 = lambda a: np.asarray(a, dtype=np.uint32)  # noqa: E731
    if field == "fused":
        host = u32(np.concatenate([arrays.fused_fwd, arrays.fused_rev]))
    elif field == "text":
        t = u32(arrays.text)
        host = np.concatenate(
            [t, np.zeros((-len(t)) % 128 + 128, np.uint32)]).reshape(-1, 128)
    elif field == "n_arr":
        host = u32([arrays.n, arrays.n + 1])
    else:
        host = u32(getattr(arrays, field))
    dev = np.asarray(getattr(index, field))
    assert dev.dtype == host.dtype and dev.shape == host.shape
    assert np.array_equal(dev, host)
