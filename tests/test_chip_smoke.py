"""chip_smoke.py's pure helpers and its refusal to run without a GPU.

The phases themselves need the card; here the genome and read generators,
the SAM recall checker and the jax.numpy brute-force oracles are checked
on the CPU, the oracles against the numpy brute force of test_pipeline.
"""

import numpy as np
import pytest

import chip_smoke as cs
from columba_jax.core import alphabet

from tests.test_pipeline import brute_edit_ends, brute_hamming

HAP = 20_000


@pytest.fixture(scope="module")
def genome():
    return cs.make_genome(3, HAP)


def test_genome_deterministic_per_seed(genome):
    names, seqs = genome
    names2, seqs2 = cs.make_genome(3, HAP)
    assert names == names2
    assert all(np.array_equal(a, b) for a, b in zip(seqs, seqs2))
    _, other = cs.make_genome(4, HAP)
    assert not np.array_equal(seqs[0], other[0])


def test_genome_shape(genome):
    names, seqs = genome
    h1, h2 = seqs[0], seqs[1]
    assert len(names) == len(seqs) == 4
    assert len(h1) == HAP
    assert (h1 == 4).sum() > 0                  # N runs
    assert abs(len(h2) - HAP) < HAP // 100     # indels, not a new genome
    # the second haplotype diverges ~0.1%: its prefix before the first
    # indel differs from hap1 at a small fraction of bases
    same = (h1[:2000] == h2[:2000]).mean()
    assert 0.97 < same <= 1.0


@pytest.mark.parametrize("m", [100, 150])
def test_sample_reads_truth(genome, m):
    _, seqs = genome
    reads, t = cs.sample_reads(5, seqs, 200, m)
    reads2, t2 = cs.sample_reads(5, seqs, 200, m)
    assert np.array_equal(reads, reads2)
    assert all(np.array_equal(t[k], t2[k]) for k in t)
    assert reads.shape == (200, m) and reads.max() <= 3
    assert set(np.unique(t["strand"])) == {0, 1}
    for i in np.nonzero(t["edits"] == 0)[0]:
        ref = seqs[t["ctg"][i]][t["pos"][i]:t["pos"][i] + m]
        fwd = alphabet.revcomp(reads[i]) if t["strand"][i] else reads[i]
        assert np.array_equal(fwd, ref)
    for i in range(len(reads)):
        ref = seqs[t["ctg"][i]][t["pos"][i] - 2:t["pos"][i] + m + 2]
        fwd = alphabet.revcomp(reads[i]) if t["strand"][i] else reads[i]
        assert cs.semiglobal_ed(fwd, ref) <= t["edits"][i]


def test_sample_pairs_truth(genome):
    _, seqs = genome
    r1, r2, t = cs.sample_pairs(6, seqs, 100, 100)
    for i in range(100):
        s = seqs[t["ctg"][i]]
        assert t["strand1"][i] != t["strand2"][i]
        lo = min(t["pos1"][i], t["pos2"][i])
        hi = max(t["pos1"][i], t["pos2"][i]) + 100
        assert 110 <= hi - lo <= 420
        for r, p, st, e in ((r1[i], t["pos1"][i], t["strand1"][i],
                             t["edits1"][i]),
                            (r2[i], t["pos2"][i], t["strand2"][i],
                             t["edits2"][i])):
            fwd = alphabet.revcomp(r) if st else r
            assert cs.semiglobal_ed(fwd, s[p - 2:p + 102]) <= e


def test_fastq_round_trip(tmp_path, genome):
    from columba_jax.io import fastq

    _, seqs = genome
    reads, _ = cs.sample_reads(7, seqs, 20, 100)
    path = str(tmp_path / "r.fq")
    cs.write_fastq(path, reads)
    recs = list(fastq.parse_reads(path))
    assert [r.name for r in recs] == [f"r{i}" for i in range(20)]
    assert np.array_equal(np.stack([r.codes for r in recs]), reads)


def test_write_fasta_round_trip(tmp_path, genome):
    from columba_jax.index.build import preprocess_fasta

    names, seqs = genome
    path = str(tmp_path / "g.fa")
    cs.write_fasta(path, names, seqs)
    codes, names2, starts = preprocess_fasta([path])
    assert names2 == names
    assert list(np.diff(starts)) == [len(s) for s in seqs]
    acgt = np.concatenate(seqs) < 4
    assert np.array_equal(codes[acgt], np.concatenate(seqs)[acgt])


SAM = """@HD\tVN:1.6
r0\t0\tchr19_hap1\t101\t60\t100M\t*\t0\t0\tA\tI\tAS:i:1\tNM:i:1
r0\t272\tchr19_hap2\t101\t0\t100M\t*\t0\t0\tA\tI\tAS:i:2\tNM:i:2
r1\t16\tchr19_hap1\t503\t60\t100M\t*\t0\t0\tA\tI\tAS:i:0\tNM:i:0
r2\t4\t*\t0\t0\t*\t*\t0\t0\tA\tI
r3\t0\tchrUn_a\t7\t60\t100M\t*\t0\t0\tA\tI\tAS:i:0\tNM:i:0
"""


def test_parse_sam(tmp_path):
    p = tmp_path / "o.sam"
    p.write_text(SAM)
    sam = cs.parse_sam(str(p))
    assert set(sam) == {"r0", "r1", "r3"}
    assert sam["r0"] == [(0, "chr19_hap1", 101, 1), (272, "chr19_hap2", 101, 2)]


@pytest.mark.parametrize("strict", [True, False])
def test_check_recall(tmp_path, genome, strict):
    names, seqs = genome
    p = tmp_path / "o.sam"
    p.write_text(SAM)
    sam = cs.parse_sam(str(p))
    truth = dict(ctg=np.array([0, 0, 0, 2]),
                 pos=np.array([100, 500, 7, 1000]),
                 strand=np.array([0, 1, 0, 0]),
                 edits=np.array([1, 0, 0, 3]))
    reads = np.zeros((4, 100), np.uint8)
    res = cs.check_recall(sam, names, seqs, reads, truth,
                          ["r0", "r1", "r2", "r3"], strict=strict)
    # r0 at origin; r1 within SLACK on the reverse strand; r2 unmapped is
    # missed; r3 has more than K edits and is not checked
    assert res["checked"] == 3
    assert res["at_origin"] == 2
    assert res["missed"] == 1 and res["missed_examples"] == ["r2"]


def test_origin_found_mates():
    recs = [(0x41 | 0x10, "c", 11, 0), (0x81, "c", 301, 1)]
    assert cs.origin_found(recs, "c", 10, 1, 0x40)
    assert cs.origin_found(recs, "c", 300, 0, 0x80)
    assert not cs.origin_found(recs, "c", 300, 0, 0x40)
    assert not cs.origin_found(recs, "c", 10 + cs.SLACK + 1, 1, 0x40)


@pytest.fixture(scope="module")
def small_text():
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    g[1000:1100] = g[2000:2100]     # a repeat so patterns hit twice
    return g


@pytest.mark.parametrize("k", [0, 1, 2])
def test_brute_hamming_matches_numpy(small_text, k):
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    pats = []
    for s in (5, 1010, 2040, 2890):
        p = small_text[s:s + 60].copy()
        for j in rng.integers(0, 60, k):
            p[j] = (p[j] + 1) % 4
        pats.append(p)
    pats.append(rng.integers(0, 4, 60).astype(np.uint8))
    pats = np.stack(pats)
    got = cs.brute_hamming(jnp.asarray(small_text), pats, k, chunk=2)
    expect = {(i, p, d) for i, pat in enumerate(pats)
              for p, d in brute_hamming(small_text, pat, k)}
    assert got == expect
    assert len(expect) >= 4


@pytest.mark.parametrize("k", [1, 2])
def test_brute_edit_matches_numpy(small_text, k):
    import jax.numpy as jnp

    rng = np.random.default_rng(10 + k)
    text = jnp.asarray(small_text)
    for s in (0, 1030, 2500):
        p = small_text[s:s + 50].copy()
        p = np.delete(p, int(rng.integers(5, 45)))
        p[int(rng.integers(0, 40))] ^= 1
        assert cs.brute_edit_ends(text, p, k) == brute_edit_ends(
            small_text, p, k)


def test_covered():
    got = {(0, 0, 100, 0), (1, 1, 50, 2)}
    brute = {(0, 0, 100, 0), (0, 0, 103, 2), (0, 0, 104, 2),
             (1, 1, 50, 2), (1, 0, 50, 1)}
    # (0,0,103,2) lies within 2k-1 = 3 of a better report; 104 does not;
    # (1,0,...) is the other strand
    assert cs.covered(brute, got, 2) == {(0, 0, 104, 2), (1, 0, 50, 1)}


def test_device_phase_refuses_cpu():
    sm = cs.Smoke(1)
    with pytest.raises(SystemExit) as e:
        cs.phase_device(sm, 1)
    assert e.value.code not in (0, None)


def test_main_exits_nonzero_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_native_phase_refuses_fallback(monkeypatch):
    monkeypatch.setenv("COLUMBA_JAX_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native libraries"):
        cs.phase_native(cs.Smoke(1))


def test_describe_without_nvidia_smi(monkeypatch):
    from columba_jax import device

    monkeypatch.setenv("PATH", "")
    assert device.describe().startswith("nvidia-smi unavailable")
