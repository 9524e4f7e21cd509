"""b-move (RLC) back-end conformance vs the Vanilla FM-index.

The reference's own methodology is output comparison across flavors
(SURVEY.md #4, DEVELOPER_MODE); here the two back-ends must agree on every
extension step and every locate, and the full pipeline must produce the
identical occurrence set on the same genome.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from columba_jax.core import alphabet
from columba_jax.index.bmove import BMoveIndex, build_bmove_from_codes
from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import bextend, blocate, extend, locate

from tests.conftest import make_genome, sample_reads


@pytest.fixture(scope="module")
def pair(small_index):
    genome, arrays = small_index
    fm = FMIndex.from_arrays(arrays)
    bm = BMoveIndex.from_arrays(build_bmove_from_codes(genome))
    return genome, fm, bm


def test_build_invariants(pair):
    genome, fm, bm = pair
    big = len(genome) + 1
    fused = np.asarray(bm.fused)
    for off, r in ((0, bm.r_fwd), (bm.r_fwd + 1, bm.r_rev)):
        tab = fused[off:off + r]
        assert tab[0, 0] == 0
        np.testing.assert_array_equal(tab[1:, 0], tab[:-1, 1])  # contiguous
        assert tab[-1, 1] == big
        assert fused[off + r, 0] == big  # sentinel
        # LF destination run contains LF position
        lf_pos, lf_run = tab[:, 2], tab[:, 3]
        assert np.all(fused[off + lf_run, 0] <= lf_pos)
        assert np.all(lf_pos < fused[off + lf_run, 1])


def test_extension_parity_random_walk(pair, rng):
    """Extend both back-ends in lockstep through random char sequences with
    random direction flips; SA ranges must match exactly and run hints must
    stay valid."""
    genome, fm, bm = pair
    B = 64
    rf = fm.full_range((B,))
    rb = bm.full_range((B,))
    fused = np.asarray(bm.fused)

    for step in range(24):
        dirs = jnp.asarray(rng.integers(0, 2, B).astype(np.int32))
        cf = extend.extend_all(fm, rf, dirs)       # (B, 4, 4)
        cb = bextend.extend_all(bm, rb, dirs)      # (B, 4, 8)
        live = np.asarray(cf[..., 1] > cf[..., 0])
        np.testing.assert_array_equal(
            np.asarray(cb[..., :4]) * live[..., None],
            np.asarray(cf) * live[..., None],
            err_msg=f"step {step}")
        # hint validity on live children
        arr = np.asarray(cb)
        for (lo_c, run_c, off) in ((0, 4, 0), (2, 6, bm.r_fwd + 1)):
            lo = arr[..., lo_c][live]
            hi1 = arr[..., lo_c + 1][live] - 1
            rlo = arr[..., run_c][live] + off
            rhi = arr[..., run_c + 1][live] + off
            assert np.all((fused[rlo, 0] <= lo) & (lo < fused[rlo, 1]))
            assert np.all((fused[rhi, 0] <= hi1) & (hi1 < fused[rhi, 1]))
        # pick one random live child per lane to continue (or reset)
        pick = rng.integers(0, 4, B)
        lanes = np.arange(B)
        ok = live[lanes, pick]
        nf = np.asarray(cf)[lanes, pick]
        nb = np.asarray(cb)[lanes, pick]
        rf = jnp.asarray(np.where(ok[:, None], nf, np.asarray(fm.full_range((B,)))))
        rb = jnp.asarray(np.where(ok[:, None], nb, np.asarray(bm.full_range((B,)))))


def test_locate_parity(pair, rng):
    genome, fm, bm = pair
    rows = jnp.asarray(rng.integers(0, len(genome) + 1, 256).astype(np.int32))
    pf = np.asarray(locate.locate_rows(fm, rows))
    pb = np.asarray(blocate.locate_rows(bm, rows))
    np.testing.assert_array_equal(pb, pf)


def test_exact_match_parity(pair, rng):
    genome, fm, bm = pair
    pats = np.stack([genome[p:p + 24] for p in
                     rng.integers(0, len(genome) - 24, 32)]).astype(np.int32)
    ef = np.asarray(extend.exact_match(fm, jnp.asarray(pats)))
    eb = np.asarray(extend.exact_match(bm, jnp.asarray(pats)))
    np.testing.assert_array_equal(eb[:, :4], ef)


@pytest.mark.parametrize("metric,switchpoint", [
    ("edit", 0), ("edit", 4), ("hamming", 0),
])
def test_pipeline_parity_rlc_vs_vanilla(pair, rng, metric, switchpoint):
    """Full ALL-mode pipeline on the RLC back-end reports the identical
    occurrence set as the Vanilla back-end (the reference's cross-flavor
    conformance discipline)."""
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    k = 2
    reads = sample_reads(rng, genome, num=10, length=80, max_err=k,
                         edits=(metric == "edit"))
    kw = dict(metric=metric, redundancy_filter=False, switchpoint=switchpoint)
    o_fm, s_fm = pipeline.match_all(fm, reads, get_scheme("kuch1", k), **kw)
    o_bm, s_bm = pipeline.match_all(bm, reads, get_scheme("kuch1", k), **kw)
    assert s_bm["overflow"] == 0
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert key(o_bm) == key(o_fm)


def test_dynamic_partitioning_rlc(pair, rng):
    """Dynamic partitioning runs on the RLC back-end (char-seeded, 8-wide
    ranges) and stays lossless: every Vanilla-uniform occurrence is found."""
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    k = 2
    reads = sample_reads(rng, genome, num=8, length=80, max_err=k, edits=True)
    o_ref, _ = pipeline.match_all(fm, reads, get_scheme("kuch1", k),
                                  metric="edit", redundancy_filter=False)
    o_dyn, s = pipeline.match_all(bm, reads, get_scheme("kuch1", k),
                                  metric="edit", redundancy_filter=False,
                                  partitioning="dynamic")
    assert s["overflow"] == 0
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert key(o_dyn) == key(o_ref)


def test_exact_mode_rlc(pair, rng):
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    reads = sample_reads(rng, genome, num=16, length=50, max_err=0)
    o_fm, _ = pipeline.match_all(fm, reads, get_scheme("kuch1", 0))
    o_bm, _ = pipeline.match_all(bm, reads, get_scheme("kuch1", 0))
    key = lambda os: {(o.read_id, o.strand, o.begin) for o in os}
    assert key(o_bm) == key(o_fm)


def test_locate_pan_genome_bounded(rng):
    """Locate on a pan-genome (20 near-identical haplotypes -> huge BWT
    runs) stays correct; the in-run stride samples bound every LF-walk at
    LOCATE_STRIDE steps regardless of run length."""
    from columba_jax.index.bmove import LOCATE_STRIDE
    from columba_jax.index.suffix import suffix_array

    unit = rng.integers(0, 4, size=2000).astype(np.uint8)
    copies = [unit]
    for _ in range(19):
        c = unit.copy()
        idx = rng.integers(0, len(c), 2)  # 0.1% divergence
        c[idx] = (c[idx] + 1 + rng.integers(0, 3, 2)) % 4
        copies.append(c)
    genome = np.concatenate(copies)
    bm = BMoveIndex.from_arrays(build_bmove_from_codes(genome))
    # huge runs really exist (r << n)
    assert bm.r_fwd < len(genome) / 10

    sa = suffix_array(genome)
    n = len(genome)
    sa_full = np.concatenate([[n], sa])
    rows = rng.integers(0, n + 1, size=512)
    got = np.asarray(blocate.locate_rows(bm, jnp.asarray(rows)))
    want = np.minimum(sa_full[rows], n)
    np.testing.assert_array_equal(got, want)
    # stride table covers every LOCATE_STRIDE-th of the n+1 BWT rows
    assert bm.sa_stride.shape[0] == -(-(n + 1) // LOCATE_STRIDE)


def test_phi_tables_identity(rng):
    """phi(SA[i]) == SA[i-1] and phinv(SA[i]) == SA[i+1] exactly, from the
    run-boundary piece tables (the r-index property textless locate rests
    on; reference src/bmove/plcp.h:59-130)."""
    from columba_jax.index.bmove import build_bmove_from_codes
    from columba_jax.index.suffix import suffix_array

    unit = rng.integers(0, 4, size=300).astype(np.uint8)
    genome = np.concatenate([unit] * 4 + [rng.integers(0, 4, 500)]).astype(
        np.uint8)
    arrays = build_bmove_from_codes(genome, textless=True)
    n = len(genome)
    sa = suffix_array(genome)
    sa_full = np.concatenate([[n], sa]).astype(np.int64)

    phi = arrays.phi_fwd.astype(np.int64)
    xs, ys, xsi, ysi = phi[:, 0], phi[:, 1], phi[:, 2], phi[:, 3]
    p = sa_full[1:]
    j = np.searchsorted(xs, p, side="right") - 1
    np.testing.assert_array_equal(ys[j] + (p - xs[j]), sa_full[:-1])
    q = sa_full[:-1]
    ji = np.searchsorted(xsi, q, side="right") - 1
    np.testing.assert_array_equal(ysi[ji] + (q - xsi[ji]), sa_full[1:])


@pytest.mark.parametrize("metric", ["hamming", "edit"])
def test_textless_matches_with_text(pair, rng, metric):
    """Textless RLC (toehold + phi locate, no packed text / stride
    samples) finds every occurrence the with-text RLC pipeline finds.
    Begins are EXACT (track_arg matched-length witness): Hamming begins
    match the with-text path bit-for-bit; edit begins may differ from the
    with-text choice by a tie among equally-optimal alignment starts
    (<= 1 position at k=2, checked tighter in
    test_textless_edit_begins_exact)."""
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    tl = BMoveIndex.from_arrays(build_bmove_from_codes(genome,
                                                       textless=True))
    assert tl.textless and tl.range_width == 12
    k = 2
    reads = sample_reads(rng, genome, num=12, length=80, max_err=k,
                         edits=(metric == "edit"))
    o_ref, _ = pipeline.match_all(bm, reads, get_scheme("kuch1", k),
                                  metric=metric, redundancy_filter=False,
                                  switchpoint=0)
    from columba_jax.index.bmove import build_bmove_from_codes as _b

    arrays_tl = _b(genome, textless=True)
    o_tl, s_tl = pipeline.match_all(
        tl, reads, get_scheme("kuch1", k), metric=metric,
        switchpoint=0, host_arrays=arrays_tl)
    assert s_tl["overflow"] == 0
    ref_by = {}
    for o in o_ref:
        ref_by.setdefault((o.read_id, o.strand), []).append(o)
    tl_by = {}
    for o in o_tl:
        tl_by.setdefault((o.read_id, o.strand), []).append(o)
    # same (read, strand) groups mapped
    assert set(tl_by) == set(ref_by)
    tol = 0 if metric == "hamming" else 1   # edit: tie among optimal starts
    for key_, occs in tl_by.items():
        ref_begins = sorted(o.begin for o in ref_by[key_])
        for o in occs:
            assert any(abs(o.begin - rb) <= tol for rb in ref_begins), (
                key_, o.begin, ref_begins)
    # recall: every with-text group position has a textless position near it
    for key_, occs in ref_by.items():
        tl_begins = sorted(o.begin for o in tl_by[key_])
        for o in occs:
            assert any(abs(o.begin - tb) <= max(tol, 2 * k) for tb in
                       tl_begins), (key_, o.begin, tl_begins)


def test_textless_index_bytes_scale_with_runs(rng):
    """On a pan-genome the textless index is r-scaled: dropping text +
    stride samples removes the n-scaled components."""
    from columba_jax.index.bmove import build_bmove_from_codes

    unit = rng.integers(0, 4, size=1000).astype(np.uint8)
    genome = np.tile(unit, 512)  # r ~ r(unit) + copies while n grows 512x
    wt = build_bmove_from_codes(genome)
    tl = build_bmove_from_codes(genome, textless=True)
    size = lambda a: sum(
        getattr(a, f).nbytes for f in
        ("fused_fwd", "fused_rev", "text", "sa_stride", "phi_fwd",
         "phi_rev"))
    assert tl.text.nbytes == 0 and tl.sa_stride.nbytes == 0
    # r << n here, so dropping the n-scaled parts shrinks the index; the
    # remaining bytes are all r-scaled (fused run rows + phi pieces)
    assert size(tl) < 0.8 * size(wt)
    r = tl.meta["runs_fwd"]
    n = len(genome)
    assert r < n / 64


def test_textless_k0_and_collection_collapse(pair, rng):
    """Round-5 refusal lifts: k=0 exact matching runs through the
    frontier-only textless pass (begins exact — no indels), and a scheme
    COLLECTION collapses to its first scheme (selection is perf-only)."""
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    arrays_tl = build_bmove_from_codes(genome, textless=True)
    tl = BMoveIndex.from_arrays(arrays_tl)
    reads = sample_reads(rng, genome, num=10, length=60, max_err=0)
    o_ref, _ = pipeline.match_all(bm, reads, get_scheme("kuch1", 0),
                                  metric="edit", redundancy_filter=False)
    o_tl, _ = pipeline.match_all(tl, reads, get_scheme("kuch1", 0),
                                 metric="edit", host_arrays=arrays_tl)
    a = set(zip(o_ref.read_id, o_ref.strand, o_ref.begin))
    b = set(zip(o_tl.read_id, o_tl.strand, o_tl.begin))
    assert a == b and len(a) >= 10
    # collection -> first scheme, same result set as that scheme alone
    k = 2
    reads2 = sample_reads(rng, genome, num=8, length=60, max_err=k,
                          edits=True)
    coll = [get_scheme("kuch1", k), get_scheme("kuch1", k).mirrored()]
    o_c, _ = pipeline.match_all(tl, reads2, coll, metric="edit",
                                host_arrays=arrays_tl)
    o_s, _ = pipeline.match_all(tl, reads2, get_scheme("kuch1", k),
                                metric="edit", host_arrays=arrays_tl)
    assert (set(zip(o_c.read_id, o_c.strand, o_c.begin, o_c.distance))
            == set(zip(o_s.read_id, o_s.strand, o_s.begin, o_s.distance)))


def test_textless_edit_begins_exact(pair, rng):
    """Every textless edit occurrence's begin is the exact start of an
    optimal alignment: an anchored semi-global DP from text[begin]
    achieves the reported distance (the matched-length witness carried by
    the executor's track_arg shadow slots; the reference carries the
    matchedStr length per DFS leaf, src/indexinterface.h:294-304)."""
    from columba_jax.core import alphabet
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, fm, bm = pair
    arrays_tl = build_bmove_from_codes(genome, textless=True)
    tl = BMoveIndex.from_arrays(arrays_tl)
    k = 2
    # errorful reads WITH indels
    reads = sample_reads(rng, genome, num=24, length=80, max_err=k,
                         edits=True)
    occs, _ = pipeline.match_all(tl, reads, get_scheme("kuch1", k),
                                 metric="edit", host_arrays=arrays_tl)

    def anchored_min_ed(read, text):
        m, t = len(read), len(text)
        prev = np.arange(t + 1, dtype=np.int64)
        prev[:] = np.minimum(prev, 10 ** 6)
        # D[0][c] = c: skipping text before the pattern costs, so a
        # distance-d result certifies an alignment STARTING at text[0]
        for j in range(1, m + 1):
            cur = np.empty(t + 1, dtype=np.int64)
            cur[0] = j
            mis = (text != read[j - 1]).astype(np.int64)
            for c in range(1, t + 1):
                cur[c] = min(prev[c - 1] + mis[c - 1], prev[c] + 1,
                             cur[c - 1] + 1)
            prev = cur
        return int(prev.min())

    assert len(occs) >= 24
    for o in occs:
        read = (reads[o.read_id] if o.strand == 0
                else alphabet.revcomp(reads[o.read_id]))
        lo = int(o.begin)
        win = genome[lo:lo + len(read) + k + 2]
        assert anchored_min_ed(read, win) == o.distance, (
            o.read_id, o.strand, lo, o.distance)
