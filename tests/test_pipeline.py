"""End-to-end conformance of the matching pipeline vs brute force.

The reference's own conformance methodology is byte-for-byte output
comparison (SURVEY.md §4); here the oracle is a numpy brute force over the
small test genome:
  - Hamming ALL mode: exact set equality of (read, strand, begin, dist).
  - Edit ALL mode: losslessness (every brute-force occurrence region is
    reported with the right distance) + soundness (every report verifies).
"""

import numpy as np
import pytest

from columba_jax.core import alphabet
from columba_jax.index.fmindex import FMIndex
from columba_jax.search import pipeline, strategy
from columba_jax.search.scheme import get_scheme

from tests.conftest import sample_reads


@pytest.fixture(scope="module")
def fm(small_index):
    genome, arrays = small_index
    return genome, FMIndex.from_arrays(arrays)


def brute_hamming(genome, read, k):
    """All (begin, dist<=k) of read against genome (one strand)."""
    m = len(read)
    win = np.lib.stride_tricks.sliding_window_view(genome, m)
    dists = (win != read).sum(axis=1)
    hits = np.nonzero(dists <= k)[0]
    return {(int(p), int(dists[p])) for p in hits}


def brute_edit_ends(genome, read, k):
    """(end, dist) pairs: best semi-global ED of read ending at each text
    position, local minima only — the same occurrence semantics the
    pipeline reports."""
    m = len(read)
    n = len(genome)
    prev = np.zeros(n + 1, dtype=np.int32)  # D[0][*] = 0 (free start)
    rows = [prev]
    for j in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int32)
        cur[0] = j
        mis = (genome != read[j - 1]).astype(np.int32)
        # vectorized: diag/up then left-scan via cummin trick
        best = np.minimum(prev[:-1] + mis, prev[1:] + 1)
        # left scan: cur[c] = min(best[c-1-ish]...) sequential -> use np.minimum.accumulate
        tmp = best - np.arange(1, n + 1)
        np.minimum.accumulate(tmp, out=tmp)
        cur[1:] = np.minimum(best, tmp + np.arange(1, n + 1))
        # include the j (all-deletions) start column effect
        cur[1:] = np.minimum(cur[1:], j)
        prev = cur
    final = prev[1:]  # ed of alignment ending at position c (end = c)
    out = set()
    for c in range(n):
        v = final[c]
        if v > k:
            continue
        left = final[c - 1] if c > 0 else 127
        right = final[c + 1] if c < n - 1 else 127
        if v > left or v > right:
            continue
        if c > 0 and v == left:
            continue
        out.add((c + 1, int(v)))
    return out


@pytest.mark.parametrize("name,k", [("pigeon", 1), ("pigeon", 2), ("kuch1", 2)])
def test_hamming_all_vs_brute(fm, rng, name, k):
    genome, index = fm
    reads = sample_reads(rng, genome, num=12, length=60, max_err=k)
    occs, stats = pipeline.match_all(
        index, reads, get_scheme(name, k), metric="hamming",
        redundancy_filter=False,
    )
    assert stats["overflow"] == 0
    got = {(o.read_id, o.strand, o.begin, o.distance) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for p, d in brute_hamming(genome, rr, k):
                expect.add((i, strand, p, d))
    assert got == expect


@pytest.mark.parametrize("name,k", [
    ("kuch1", 1), ("kuch1", 2), ("kuch1", 3),
    ("pigeon", 2), ("kianfar", 2), ("01*0", 2), ("kuch2", 2),
])
def test_edit_all_vs_brute(fm, rng, name, k):
    genome, index = fm
    reads = sample_reads(rng, genome, num=10, length=72, max_err=k, edits=True)
    occs, stats = pipeline.match_all(
        index, reads, get_scheme(name, k), metric="edit",
        redundancy_filter=False,
    )
    assert stats["overflow"] == 0
    got = {(o.read_id, o.strand, o.end, o.distance) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for e, d in brute_edit_ends(genome, rr, k):
                expect.add((i, strand, e, d))
    missing = expect - got
    spurious = got - expect
    assert not missing, f"lost occurrences: {sorted(missing)[:10]}"
    assert not spurious, f"spurious occurrences: {sorted(spurious)[:10]}"


def test_exact_mode(fm, rng):
    genome, index = fm
    reads = sample_reads(rng, genome, num=16, length=50, max_err=0)
    occs, stats = pipeline.match_all(index, reads, get_scheme("kuch1", 0))
    got = {(o.read_id, o.strand, o.begin) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for p, d in brute_hamming(genome, rr, 0):
                expect.add((i, strand, p))
    assert got == expect


def test_naive_scheme_edit(fm, rng):
    genome, index = fm
    reads = sample_reads(rng, genome, num=4, length=40, max_err=1, edits=True)
    occs, _ = pipeline.match_all(
        index, reads, get_scheme("naive", 1), metric="edit",
        redundancy_filter=False, capacity=1 << 15,
    )
    got = {(o.read_id, o.strand, o.end, o.distance) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for e, d in brute_edit_ends(genome, rr, 1):
                expect.add((i, strand, e, d))
    assert got == expect


def test_naive_scheme_deep_k(rng):
    """k=16 exceeds the old 6-bit colMin packing cap (kb<=15): the 7-bit
    slots must carry band offsets up to 2k (reference MAX_K_EDIT=20,
    src/bitparallelmatrix.h:309-316). Small genome: the naive k=16
    frontier holds every SA range with bound <= k, so demand scales
    with n."""
    from columba_jax.index.build import build_index_from_codes

    from tests.conftest import make_genome

    genome = make_genome(np.random.default_rng(7), 6000)
    index = FMIndex.from_arrays(build_index_from_codes(genome))
    k = 16
    reads = sample_reads(rng, genome, num=2, length=60, max_err=8,
                         edits=True)
    occs, stats = pipeline.match_all(
        index, reads, get_scheme("naive", k), metric="edit",
        redundancy_filter=False, capacity=1 << 15,
    )
    assert stats["overflow"] == 0
    got = {(o.read_id, o.strand, o.end, o.distance) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for e, d in brute_edit_ends(genome, rr, k):
                expect.add((i, strand, e, d))
    missing = expect - got
    spurious = got - expect
    assert not missing, f"lost occurrences: {sorted(missing)[:10]}"
    assert not spurious, f"spurious occurrences: {sorted(spurious)[:10]}"


def test_edit_insertion_at_part_boundaries(fm, rng):
    """Regression: reads with an inserted char exactly at a part/pivot
    boundary must still be found (band init allows pattern-insertions at
    side boundaries)."""
    genome, index = fm
    m, k = 100, 4  # kuch1 k=4: 5 parts of 20 -> boundaries at 20/40/60/80
    reads = []
    for b in (20, 40, 60, 80):
        p = int(rng.integers(0, len(genome) - m - 2))
        ins = np.concatenate(
            [genome[p:p + b], [int(rng.integers(0, 4))], genome[p + b:p + m - 1]]
        ).astype(np.uint8)
        reads.append(ins[:m])
    occs, stats = pipeline.match_all(
        index, np.stack(reads), get_scheme("kuch1", k), metric="edit",
    )
    assert stats["overflow"] == 0
    found = {o.read_id for o in occs if o.distance <= 2}
    assert found == {0, 1, 2, 3}


def test_kmer_table_and_seeded_matching(fm, rng):
    """Seed table entries equal naive ranges; seeded run == unseeded run."""
    import jax.numpy as jnp

    from columba_jax.index import kmer

    genome, index = fm
    table = np.asarray(kmer.build_kmer_table(index))
    # spot-check a few kmers against exact_match
    from columba_jax.ops import extend as ext

    pats = []
    for _ in range(20):
        p = int(rng.integers(0, len(genome) - 10))
        pats.append(genome[p:p + 10])
    pats = np.stack(pats).astype(np.int32)
    expect = np.asarray(ext.exact_match(index, jnp.asarray(pats)))
    codes = np.asarray(kmer.pack_codes(jnp.asarray(pats)))
    np.testing.assert_array_equal(table[codes], expect)

    reads = sample_reads(rng, genome, num=8, length=60, max_err=2, edits=True)
    occs_plain, _ = pipeline.match_all(
        index, reads, get_scheme("kuch1", 2), metric="edit",
        redundancy_filter=False,
    )
    occs_seeded, stats = pipeline.match_all(
        index, reads, get_scheme("kuch1", 2), metric="edit",
        redundancy_filter=False, kmer_table=jnp.asarray(table),
    )
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert key(occs_plain) == key(occs_seeded)
    assert stats["overflow"] == 0


def test_dynamic_scheme_selection(fm, rng):
    """Multi-scheme dynamic selection finds the same occurrence set as each
    single lossless scheme."""
    from columba_jax.search.scheme import get_multi_scheme

    genome, index = fm
    reads = sample_reads(rng, genome, num=10, length=72, max_err=2, edits=True)
    multi = get_multi_scheme("kuch1", 2)
    assert len(multi) == 2
    occs_multi, stats = pipeline.match_all(
        index, reads, multi, metric="edit", redundancy_filter=False,
    )
    occs_single, _ = pipeline.match_all(
        index, reads, get_scheme("kuch1", 2), metric="edit",
        redundancy_filter=False,
    )
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert key(occs_multi) == key(occs_single)
    assert stats["overflow"] == 0


def test_columba_multi_scheme(fm, rng):
    from columba_jax.search.scheme import get_multi_scheme

    genome, index = fm
    reads = sample_reads(rng, genome, num=6, length=100, max_err=2, edits=True)
    multi = get_multi_scheme("columba", 2)
    assert len(multi) == 3  # minU + mirror + mid
    occs, stats = pipeline.match_all(
        index, reads, multi, metric="edit", redundancy_filter=False,
    )
    # soundness + losslessness vs brute force
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for e, d in brute_edit_ends(genome, rr, 2):
                expect.add((i, strand, e, d))
    got = {(o.read_id, o.strand, o.end, o.distance) for o in occs}
    assert got == expect


def test_parametric_schedule_random_partitions(fm, rng):
    """The per-read parametric schedule (dynamic-partitioning machinery)
    must be lossless for ARBITRARY valid partitions: same occurrence set as
    the static uniform schedule."""
    genome, index = fm
    m, k = 90, 2
    reads = sample_reads(rng, genome, num=8, length=m, max_err=k, edits=True)
    scheme = get_scheme("kuch1", k)
    p = scheme.num_parts
    # random boundaries respecting part length > 2k
    R2 = 2 * len(reads)
    pts = np.zeros((R2, p + 1), dtype=np.int32)
    pts[:, p] = m
    for r in range(R2):
        while True:
            cuts = np.sort(rng.integers(6, m - 6, size=p - 1))
            cand = np.concatenate([[0], cuts, [m]])
            if np.diff(cand).min() > 2 * k:
                pts[r] = cand
                break
    occs_dyn, stats = pipeline.match_all(
        index, reads, scheme, metric="edit", redundancy_filter=False,
        partition_pts=pts,
    )
    occs_uni, _ = pipeline.match_all(
        index, reads, scheme, metric="edit", redundancy_filter=False,
    )
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert stats["overflow"] == 0
    assert key(occs_dyn) == key(occs_uni)


def test_dynamic_partitioning_end_to_end(fm, rng):
    """-p dynamic: greedy per-read partitions + parametric schedules give
    the same occurrence set as uniform partitioning (losslessness)."""
    genome, index = fm
    m, k = 90, 2
    reads = sample_reads(rng, genome, num=8, length=m, max_err=k, edits=True)
    occs_dyn, stats = pipeline.match_all(
        index, reads, get_scheme("kuch1", k), metric="edit",
        redundancy_filter=False, partitioning="dynamic",
    )
    occs_uni, _ = pipeline.match_all(
        index, reads, get_scheme("kuch1", k), metric="edit",
        redundancy_filter=False,
    )
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert stats["overflow"] == 0
    assert key(occs_dyn) == key(occs_uni)


@pytest.mark.parametrize("partitioning", ["uniform", "dynamic"])
def test_in_text_crossover_equivalence(fm, rng, partitioning):
    """switchpoint > 0 (mid-search in-text verification) must report the
    same occurrence set as pure in-index search."""
    genome, index = fm
    m, k = 90, 2
    reads = sample_reads(rng, genome, num=10, length=m, max_err=k, edits=True)
    kw = dict(metric="edit", redundancy_filter=False, partitioning=partitioning)
    base, _ = pipeline.match_all(index, reads, get_scheme("kuch1", k), **kw)
    itv, stats = pipeline.match_all(
        index, reads, get_scheme("kuch1", k), switchpoint=4, **kw)
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert stats["overflow"] == 0
    assert key(base) == key(itv)


@pytest.mark.parametrize("name,k,m", [
    ("kuch1", 4, 40),    # parts of 8 = 2k: windows overlap, W=2
    ("minU", 7, 100),    # parts ~12 < 2k+1=15 (the reference's k=7 default)
    ("greedy", 9, 100),  # greedy high-k scheme at short-part regime
    ("greedy", 13, 150), # reference MAX_K
])
def test_edit_all_short_parts_vs_brute(fm, rng, name, k, m):
    """Schemes whose parts are shorter than 2k+1 (multi-register colMin
    windows) must stay lossless and sound."""
    from columba_jax.search.scheme import load_scheme_folder
    import os as _os

    genome, index = fm
    if name == "greedy":
        scheme = load_scheme_folder(
            _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), "columba_jax", "..", "schemes",
                "columba_greedy"), k)
    else:
        scheme = get_scheme(name, k)
    sd = pipeline.compile_cached(scheme, m, "edit")
    assert sd.W > 1
    reads = sample_reads(rng, genome, num=6, length=m, max_err=k, edits=True)
    occs, stats = pipeline.match_all(
        index, reads, scheme, metric="edit", redundancy_filter=False,
        capacity=1 << 16, max_locate=1 << 16,
    )
    assert stats["overflow"] == 0
    got = {(o.read_id, o.strand, o.end, o.distance) for o in occs}
    expect = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            for e, d in brute_edit_ends(genome, rr, k):
                expect.add((i, strand, e, d))
    missing = expect - got
    spurious = got - expect
    assert not missing, f"lost occurrences: {sorted(missing)[:10]}"
    assert not spurious, f"spurious occurrences: {sorted(spurious)[:10]}"


@pytest.mark.parametrize("partitioning", ["uniform", "dynamic"])
def test_two_stage_exact_loop_equivalence(fm, rng, partitioning):
    """ex_split/ex_cap (mid-exact-prefix lane compaction) must report the
    same occurrence set as the single-stage loop."""
    genome, index = fm
    m, k = 90, 2
    reads = sample_reads(rng, genome, num=12, length=m, max_err=k, edits=True)
    kw = dict(metric="edit", redundancy_filter=False,
              partitioning=partitioning, switchpoint=4)
    base, _ = pipeline.match_all(index, reads, get_scheme("kuch1", k), **kw)
    # without a k-mer table nearly every lane is still alive at shallow
    # depth (short segments match everywhere), so split late enough that
    # junk lanes have died (depth 12: 4^12 >> |genome|)
    split, stats = pipeline.match_all(
        index, reads, get_scheme("kuch1", k), ex_split=12, ex_cap=48, **kw)
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert stats["overflow"] == 0
    assert key(base) == key(split)


def test_exact_compaction_overflow_retry(fm, rng):
    """An ex_cap too small for the surviving lanes must trigger the lossless
    auto-capacity retry (which scales ex_cap too) and still return the full
    occurrence set with overflow == 0."""
    genome, index = fm
    m, k = 90, 2
    reads = sample_reads(rng, genome, num=12, length=m, max_err=k, edits=True)
    kw = dict(metric="edit", redundancy_filter=False, switchpoint=4)
    base, _ = pipeline.match_all(index, reads, get_scheme("kuch1", k), **kw)
    # ex_split=6 is before junk lanes die (depth 6), so nearly all 72 lanes
    # survive stage 1 and ex_cap=24 overflows; the retry runs at 96
    tiny, stats = pipeline.match_all(
        index, reads, get_scheme("kuch1", k), ex_split=6, ex_cap=24, **kw)
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    assert stats["overflow"] == 0
    assert key(base) == key(tiny)


def test_read_with_n_bases(fm):
    """N in a read (code 4) matches nothing: it costs one error at its
    position and the rest of the read still anchors the occurrence
    (reference: N chars mismatch all, src/bitparallelmatrix.cpp match
    vectors)."""
    genome, index = fm
    r = genome[5000:5090].astype(np.uint8).copy()
    r[40] = 4
    occs, _ = pipeline.match_all(index, r[None], get_scheme("kuch1", 2),
                                 metric="edit")
    hits = [(o.begin, o.distance) for o in occs
            if o.read_id == 0 and o.strand == 0]
    assert any(abs(b - 5000) <= 2 and d >= 1 for b, d in hits), hits


def test_occurrence_at_text_start(fm):
    """Occurrences within kb of text position 0 must be found (regression:
    gather_window used to anchor negative window starts at 0 without
    shifting, losing every match at the genome start)."""
    genome, index = fm
    for start in (0, 1, 2):
        r = genome[start:start + 60].astype(np.uint8).copy()
        r[30] = (r[30] + 1) % 4
        occs, _ = pipeline.match_all(index, r[None], get_scheme("kuch1", 2),
                                     metric="edit")
        hit = [o for o in occs
               if o.strand == 0 and abs(o.begin - start) <= 2]
        assert hit, f"missed occurrence at genome position {start}"


def test_best_plus_x_semantics(fm):
    """Pin THIS repo's documented best+x semantics (tools/parity.py -x):
    for x>0 a read whose best stratum is 0 is still REPORTED, with every
    occurrence in [best, best+x] (the reference diverges here by design:
    its stratified loop emits such reads as unmapped,
    src/searchstrategy.cpp:676-744)."""
    from columba_jax.search import strategy

    genome, index = fm
    # a read sampled exactly, with a planted 1-edit second occurrence
    m = 60
    src = genome[3000:3000 + m].astype(np.uint8)
    g2 = genome.copy()
    g2[9000:9000 + m] = src
    g2[9000 + 25] = (src[25] + 1) % 4
    from columba_jax.index.build import build_index_from_codes

    idx2 = FMIndex.from_arrays(build_index_from_codes(g2))
    cfg = strategy.MappingConfig(scheme_name="kuch1", mode="best",
                                 best_plus_x=1, switchpoint=0,
                                 partitioning="uniform")
    mapped = strategy.map_batch_best(idx2, src[None], cfg)
    mr = mapped[0]
    assert mr.best == 0, "exact-match read must be reported with best=0"
    dists = {(o.begin, o.distance) for o in mr.occs if o.strand == 0}
    assert (3000, 0) in dists, dists
    assert any(abs(b - 9000) <= 1 and d == 1 for b, d in dists), (
        "x=1 must include the distance-1 stratum occurrence", dists)
    # occurrences beyond best + x are excluded
    assert all(d <= 1 for _, d in dists), dists


def test_cross_boundary_trimming(rng):
    """Occurrences straddling a concatenated-sequence boundary are trimmed
    (clip within k of the boundary + re-verify) or dropped, mirroring the
    reference's findSeqName (src/indexinterface.cpp:799-897)."""
    from columba_jax.index.build import build_index_from_codes

    g = rng.integers(0, 4, size=8000).astype(np.uint8)
    starts = np.array([0, 4000, 8000], dtype=np.int64)
    arrays = build_index_from_codes(
        g, seq_names=["chrA", "chrB"], seq_starts=starts)
    idx = FMIndex.from_arrays(arrays)
    m, k = 60, 2

    # read 0: fully inside chrA (control, must survive)
    r0 = g[1000:1000 + m].copy()
    # read 1: straddles the boundary by 1 base (begin = 3999) -> end is
    # k-trimmable to the boundary only if the FULL read still aligns within
    # k against chrA's tail; losing 1 base costs 1 edit -> survives at k=2
    # as a trimmed occurrence with distance >= 1
    r1 = g[4000 - m + 1:4000 + 1].copy()
    # read 2: straddles by m/2 -> far beyond k on both sides -> dropped
    r2 = g[4000 - m // 2:4000 + m - m // 2].copy()
    reads = np.stack([r0, r1, r2])

    cfg = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                 mode="all", max_distance=k, arrays=arrays)
    mapped = strategy.map_batch_all(idx, reads, cfg)

    assert mapped[0].occs and mapped[0].best == 0
    for o in mapped[0].occs:
        assert o.end <= 4000
    # read 1: any surviving occurrence must lie entirely within ONE
    # sequence and carry the re-verified (worse) distance
    for o in mapped[1].occs:
        s_lo = int(np.searchsorted(starts, o.end - 1, side="right") - 1)
        assert o.begin >= starts[s_lo] and o.end <= starts[s_lo + 1]
        assert o.distance >= 1
    # read 2: the straddling alignment cannot be trimmed within k
    for o in mapped[2].occs:
        s_lo = int(np.searchsorted(starts, o.end - 1, side="right") - 1)
        assert o.begin >= starts[s_lo] and o.end <= starts[s_lo + 1]
        assert not (3970 < o.end <= 4030), "straddler survived untrimmed"
