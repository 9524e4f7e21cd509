"""Paired-end mapping: pairing windows, orientations, inference, SAM."""

import numpy as np
import pytest

from columba_jax.core import alphabet
from columba_jax.index.fmindex import FMIndex
from columba_jax.search import paired, strategy


@pytest.fixture(scope="module")
def pe_setup(small_index, rng):
    genome, arrays = small_index
    index = FMIndex.from_arrays(arrays)
    m, insert = 50, 200
    n = len(genome)
    r1, r2, positions = [], [], []
    for _ in range(16):
        p = int(rng.integers(0, n - insert - 10))
        frag = genome[p:p + insert]
        r1.append(frag[:m].copy())                      # fwd
        r2.append(alphabet.revcomp(frag[-m:]).copy())   # rc (FR orientation)
        positions.append(p)
    return genome, arrays, index, np.stack(r1), np.stack(r2), positions, m, insert


def test_pair_all_fr(pe_setup):
    genome, arrays, index, r1, r2, positions, m, insert = pe_setup
    pcfg = paired.PairedConfig(orientation="fr", min_insert=100,
                               max_insert=300, infer=False)
    mapped = paired.map_pairs_all(
        index, r1, r2, "kuch1", 1, "edit", pcfg, arrays.seq_starts,
    )
    for i, mp in enumerate(mapped):
        assert mp.pairs, f"pair {i} not concordantly mapped"
        best = min(mp.pairs, key=lambda p: p.total_distance)
        assert best.total_distance == 0
        assert abs(best.up.begin - positions[i]) <= 1
        assert abs(best.fragment - insert) <= 2


def test_pair_inference(pe_setup):
    genome, arrays, index, r1, r2, positions, m, insert = pe_setup
    cfg = strategy.MappingConfig(scheme_name="kuch1", metric="edit")
    pcfg = paired.infer_parameters(index, r1, r2, cfg, arrays.seq_starts)
    assert pcfg.orientation == "fr"
    assert pcfg.min_insert <= insert <= pcfg.max_insert


def test_pair_sam_emission(pe_setup):
    genome, arrays, index, r1, r2, positions, m, insert = pe_setup
    from columba_jax.io.fastq import ReadRecord

    pcfg = paired.PairedConfig(orientation="fr", min_insert=100,
                               max_insert=300, infer=False)
    mapped = paired.map_pairs_all(
        index, r1, r2, "kuch1", 1, "edit", pcfg, arrays.seq_starts,
    )
    recs1 = [ReadRecord(f"p{i}", r1[i], "I" * m) for i in range(len(r1))]
    recs2 = [ReadRecord(f"p{i}", r2[i], "I" * m) for i in range(len(r2))]
    lines = paired.emit_sam_paired(recs1, recs2, mapped, arrays, kb=1)
    primaries = [l.split("\t") for l in lines if not int(l.split("\t")[1]) & 0x100]
    assert len(primaries) == 2 * len(r1)
    for f in primaries:
        flag = int(f[1])
        assert flag & 0x1 and flag & 0x2  # paired + proper
        assert f[6] == "="
        tlen = int(f[8])
        assert abs(abs(tlen) - insert) <= 2


def test_pair_one_side_garbage(pe_setup, rng):
    genome, arrays, index, r1, r2, positions, m, insert = pe_setup
    junk = rng.integers(0, 4, size=(len(r1), m)).astype(np.uint8)
    pcfg = paired.PairedConfig(orientation="fr", min_insert=100,
                               max_insert=300, infer=False)
    mapped = paired.map_pairs_all(
        index, r1, junk, "kuch1", 1, "edit", pcfg, arrays.seq_starts,
    )
    for mp in mapped:
        assert not mp.pairs and not mp.discordant
        assert mp.unpaired1  # read1 still maps alone


@pytest.fixture(scope="module")
def repeat_pe_setup(rng):
    """Genome with 4 diverged copies of a 600 bp unit: pairs sampled from
    the unit multi-map with DIFFERENT total distances per locus — the
    workload that separates stratified PE BEST from PE ALL emission."""
    from columba_jax.index.build import build_index_from_codes

    unit = rng.integers(0, 4, size=600).astype(np.uint8)
    chunks = [rng.integers(0, 4, size=3000).astype(np.uint8), unit]
    for _ in range(3):
        c = unit.copy()
        idx = rng.integers(0, len(c), 4)
        c[idx] = (c[idx] + 1 + rng.integers(0, 3, 4)) % 4
        chunks.append(rng.integers(0, 4, size=1500).astype(np.uint8))
        chunks.append(c)
    chunks.append(rng.integers(0, 4, size=3000).astype(np.uint8))
    genome = np.concatenate(chunks)
    arrays = build_index_from_codes(genome)
    index = FMIndex.from_arrays(arrays)
    m, insert = 50, 300
    r1, r2 = [], []
    for _ in range(12):
        p = int(rng.integers(0, 600 - insert - 1))
        frag = unit[p:p + insert]
        r1.append(frag[:m].copy())
        r2.append(alphabet.revcomp(frag[-m:]).copy())
    return genome, arrays, index, np.stack(r1), np.stack(r2)


def test_pair_best_stratified_vs_all_oracle(repeat_pe_setup):
    """map_pairs_best == (map_pairs_all at full cutoff, then keep only the
    best total-distance stratum) on a multi-mapping workload."""
    genome, arrays, index, r1, r2 = repeat_pe_setup
    cfg = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                 mode="best", min_identity=95)
    pcfg = paired.PairedConfig(orientation="fr", min_insert=200,
                               max_insert=400, infer=False)
    got = paired.map_pairs_best(index, r1, r2, cfg, pcfg, arrays.seq_starts)

    m = r1.shape[1]
    cut = strategy.get_max_ed(
        95, m, max(strategy.max_supported_k("kuch1", m, "edit"), 1))
    oracle = paired.map_pairs_all(index, r1, r2, "kuch1", cut, "edit",
                                  pcfg, arrays.seq_starts)
    for i, (g, o) in enumerate(zip(got, oracle)):
        assert o.pairs, f"pair {i}: oracle found nothing"
        assert g.pairs, f"pair {i}: best mode found nothing"
        b = min(p.total_distance for p in o.pairs)
        want = {(p.up.strand, p.up.end, p.down.strand, p.down.end)
                for p in o.pairs if p.total_distance == b}
        have = {(p.up.strand, p.up.end, p.down.strand, p.down.end)
                for p in g.pairs}
        assert min(p.total_distance for p in g.pairs) == b
        assert have == want, f"pair {i}: best-stratum sets differ"


def test_pair_best_plus_x(repeat_pe_setup):
    """best+x widens emission to total distances in [best, best+x]."""
    genome, arrays, index, r1, r2 = repeat_pe_setup
    pcfg = paired.PairedConfig(orientation="fr", min_insert=200,
                               max_insert=400, infer=False)
    cfg0 = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                  mode="best", best_plus_x=0)
    cfg2 = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                  mode="best", best_plus_x=2)
    got0 = paired.map_pairs_best(index, r1, r2, cfg0, pcfg, arrays.seq_starts)
    got2 = paired.map_pairs_best(index, r1, r2, cfg2, pcfg, arrays.seq_starts)
    for g0, g2 in zip(got0, got2):
        if not g0.pairs:
            continue
        b = min(p.total_distance for p in g0.pairs)
        assert all(p.total_distance == b for p in g0.pairs)
        assert all(b <= p.total_distance <= b + 2 for p in g2.pairs)
        k0 = {(p.up.strand, p.up.end, p.down.strand, p.down.end)
              for p in g0.pairs}
        k2 = {(p.up.strand, p.up.end, p.down.strand, p.down.end)
              for p in g2.pairs}
        assert k0 <= k2


def test_pair_best_unpaired_fallback(repeat_pe_setup, rng):
    """One garbage side -> best-only unpaired occurrences of the other."""
    genome, arrays, index, r1, r2 = repeat_pe_setup
    junk = rng.integers(0, 4, size=r2.shape).astype(np.uint8)
    cfg = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                 mode="best")
    pcfg = paired.PairedConfig(orientation="fr", min_insert=200,
                               max_insert=400, infer=False)
    got = paired.map_pairs_best(index, r1, junk, cfg, pcfg, arrays.seq_starts)
    for mp in got:
        assert not mp.pairs and not mp.discordant
        assert mp.unpaired1
        b = min(o.distance for o in mp.unpaired1)
        assert all(o.distance == b for o in mp.unpaired1)
