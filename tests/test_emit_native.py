"""Byte-parity of the native (C++) SAM emitter vs the pure-Python path.

The native emitter (columba_jax/native/emit.cpp via io/emit.py) must
produce byte-identical SAM to strategy.emit_sam for every configuration:
plain / XA-folded, with / without CIGAR, with / without unmapped records,
kb 0..4, multi-sequence texts with boundary-trimmed occurrences, reads
with N characters, and repeat-heavy multimaps.
"""

import numpy as np
import pytest

from columba_jax.core import alphabet
from columba_jax.index.build import build_index_from_codes, decoded_text
from columba_jax.index.fmindex import FMIndex
from columba_jax.io import emit
from columba_jax.io.fastq import ReadRecord
from columba_jax.search import pipeline
from columba_jax.search.scheme import get_scheme
from columba_jax.search.strategy import MappedRead, emit_sam

from .conftest import make_genome, sample_reads

pytestmark = pytest.mark.skipif(not emit.available(),
                                reason="native emit lib unavailable")


@pytest.fixture(scope="module")
def fm3(rng):
    """Multi-sequence genome (3 seqs) with repeats, plus its index."""
    seqs = [make_genome(rng, 900), make_genome(rng, 700),
            make_genome(rng, 500)]
    # plant a shared repeat so multimaps + redundancy filtering trigger
    rep = make_genome(rng, 80)
    seqs[0][100:180] = rep
    seqs[1][300:380] = rep
    seqs[2][50:130] = rep
    genome = np.concatenate(seqs)
    starts = np.array([0, 900, 1600, 2100], dtype=np.int64)
    arrays = build_index_from_codes(
        genome, sa_sparseness=1,
        seq_names=["chrA", "chrB", "chrC"], seq_starts=starts)
    return genome, arrays, FMIndex.from_arrays(arrays)


def _records(reads, rng):
    recs = []
    for i, r in enumerate(reads):
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 40,
                                                              len(r)))
        recs.append(ReadRecord(f"read{i}", r, qual))
    return recs


def _mapped_from_occs(occs, n_reads):
    out = [MappedRead() for _ in range(n_reads)]
    for o in occs:
        out[o.read_id].occs.append(o)
    for mr in out:
        if mr.occs:
            mr.best = min(o.distance for o in mr.occs)
            mr.n_best = sum(1 for o in mr.occs if o.distance == mr.best)
    return out


def _both(fm3, recs, reads, occs, kb, **kw):
    genome, arrays, index = fm3
    mapped = _mapped_from_occs(occs, len(reads))
    want = "".join(emit_sam(recs, mapped, arrays, index, kb, **kw))
    names_buf, name_offs = emit.pack_strings([r.name for r in recs])
    quals_buf, qual_offs = emit.pack_strings([r.qual for r in recs])
    got = emit.emit_sam_native(
        np.ascontiguousarray(reads), names_buf, name_offs, quals_buf,
        qual_offs, occs, arrays, decoded_text(arrays), kb,
        xa_tag=kw.get("xa_tag", False),
        unmapped_records=kw.get("unmapped_records", True),
        with_cigar=kw.get("with_cigar", True), n_threads=3)
    assert got is not None
    assert got.decode() == want


@pytest.mark.parametrize("k,metric", [(0, "hamming"), (2, "hamming"),
                                      (2, "edit"), (3, "edit")])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(xa_tag=True),
    dict(with_cigar=False),
    dict(unmapped_records=False),
])
def test_parity_modes(fm3, rng, k, metric, kw):
    genome, arrays, index = fm3
    reads = sample_reads(rng, genome, num=24, length=60, max_err=k,
                         edits=(metric == "edit"))
    # a few reads with Ns and a few junk reads (unmapped)
    reads[0][5] = 4
    reads[1][:] = rng.integers(0, 4, 60)
    recs = _records(reads, rng)
    scheme = get_scheme("kuch1" if k else "pigeon", k)
    occs, _ = pipeline.match_all(index, reads, scheme, metric=metric)
    kb = k if metric == "edit" else 0
    occs = pipeline.apply_boundary_trim(occs, reads, arrays, kb, k)
    _both(fm3, recs, reads, occs, kb, **kw)


def test_parity_multimap(fm3, rng):
    """Reads inside the planted repeat -> 3+ occurrences each."""
    genome, arrays, index = fm3
    reads = np.stack([genome[110:160], genome[1310:1360],
                      alphabet.revcomp(genome[60:110])])
    recs = _records(reads, rng)
    occs, _ = pipeline.match_all(index, reads, get_scheme("kuch1", 2),
                                 metric="edit")
    occs = pipeline.apply_boundary_trim(occs, reads, arrays, 2, 2)
    _both(fm3, recs, reads, occs, 2)
    _both(fm3, recs, reads, occs, 2, xa_tag=True)


def test_parity_boundary(fm3, rng):
    """Reads sampled across sequence boundaries exercise trimming."""
    genome, arrays, index = fm3
    rows = []
    for b in (900, 1600):
        for off in (-40, -25, -10):
            rows.append(genome[b + off: b + off + 50])
    reads = np.stack(rows)
    recs = _records(reads, rng)
    occs, _ = pipeline.match_all(index, reads, get_scheme("kuch1", 2),
                                 metric="edit")
    occs = pipeline.apply_boundary_trim(occs, reads, arrays, 2, 2)
    _both(fm3, recs, reads, occs, 2)


def _pe_both(fm3, recs1, recs2, mapped, kb):
    genome, arrays, index = fm3
    from columba_jax.search import paired

    want = "".join(paired.emit_sam_paired(recs1, recs2, mapped, arrays,
                                          kb))
    got = emit.emit_sam_pe_native(recs1, recs2, mapped, arrays,
                                  decoded_text(arrays), kb, n_threads=3)
    assert got is not None
    assert got.decode() == want


def _pe_sample(rng, genome, n, m, insert, n_junk=0):
    r1, r2 = [], []
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - insert - 10))
        frag = genome[p:p + insert]
        a, b = frag[:m].copy(), alphabet.revcomp(frag[-m:]).copy()
        for r in (a, b):       # sprinkle mismatches
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(0, m))] = rng.integers(0, 4)
        r1.append(a)
        r2.append(b)
    for _ in range(n_junk):    # junk pairs -> unpaired/unmapped records
        r1.append(rng.integers(0, 4, m).astype(np.uint8))
        r2.append(rng.integers(0, 4, m).astype(np.uint8))
    return np.stack(r1), np.stack(r2)


@pytest.mark.parametrize("mode", ["all", "best"])
def test_pe_parity(fm3, rng, mode):
    """Native PE emitter vs paired.emit_sam_paired: byte parity across
    concordant pairs, multimapped repeat pairs, unpaired and unmapped."""
    genome, arrays, index = fm3
    from columba_jax.search import paired, strategy

    r1, r2 = _pe_sample(rng, genome, n=14, m=50, insert=180, n_junk=4)
    pcfg = paired.PairedConfig(orientation="fr", min_insert=100,
                               max_insert=260, infer=False)
    if mode == "all":
        k = 2
        mapped = paired.map_pairs_all(index, r1, r2, "kuch1", k, "edit",
                                      pcfg, arrays.seq_starts,
                                      arrays=arrays)
    else:
        cfg = strategy.MappingConfig(scheme_name="kuch1", metric="edit",
                                     arrays=arrays)
        k = strategy.best_cutoff_for(cfg, r1.shape[1])
        mapped = paired.map_pairs_best(index, r1, r2, cfg, pcfg,
                                       arrays.seq_starts)
    recs1 = _records(r1, rng)
    recs2 = _records(r2, rng)
    _pe_both(fm3, recs1, recs2, mapped, kb=k)


def test_pe_parity_fuzz(fm3, rng):
    genome, arrays, index = fm3
    from columba_jax.search import paired

    for trial in range(5):
        n = int(rng.integers(1, 16))
        m = int(rng.integers(30, 70))
        insert = int(rng.integers(3 * m, 5 * m))
        k = int(rng.integers(1, 3))
        r1, r2 = _pe_sample(rng, genome, n=n, m=m, insert=insert,
                            n_junk=int(rng.integers(0, 3)))
        pcfg = paired.PairedConfig(
            orientation="fr", min_insert=max(0, insert - 60),
            max_insert=insert + 60, infer=False,
            discordant=bool(rng.integers(0, 2)))
        mapped = paired.map_pairs_all(index, r1, r2, "kuch1", k, "edit",
                                      pcfg, arrays.seq_starts,
                                      arrays=arrays)
        _pe_both(fm3, _records(r1, rng), _records(r2, rng), mapped, kb=k)


def test_parity_fuzz(fm3, rng):
    """Randomized fuzz over many batches."""
    genome, arrays, index = fm3
    for trial in range(6):
        k = int(rng.integers(1, 4))
        n = int(rng.integers(1, 30))
        mlen = int(rng.integers(30, 90))
        reads = sample_reads(rng, genome, num=n, length=mlen, max_err=k,
                             edits=True)
        nnoise = int(rng.integers(0, max(1, n // 3)))
        for j in range(nnoise):
            reads[j] = rng.integers(0, 4, mlen)
        recs = _records(reads, rng)
        occs, _ = pipeline.match_all(index, reads, get_scheme("kuch1", k),
                                     metric="edit")
        occs = pipeline.apply_boundary_trim(occs, reads, arrays, k, k)
        _both(fm3, recs, reads, occs, k)
        _both(fm3, recs, reads, occs, k, xa_tag=True)
