"""Block-partitioned index: parity vs a single monolithic index.

The blocked flavor exists for genomes past the 4.29 Gbp uint32 ceiling
(reference covers that regime via 64-bit words + Big-BWT,
src/definitions.h:69-75, src/bmove/columba_build_pfp.sh); blocks hold whole
sequences, so the merged occurrence set must equal the single-index run's
on any genome — tested here at small scale (the >4.29 Gbp scale run lives
in tools/bigbuild.py --blocks).
"""

import numpy as np
import pytest

from columba_jax import cli
from columba_jax.index.blocked import partition_sequences


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    wd = tmp_path_factory.mktemp("blkwl")
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGT"), 30000)) for _ in range(4)]
    fa = wd / "g.fa"
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">chr{i}\n{s}\n")
    # reads from every sequence, some mutated, some reverse-complemented
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fq = wd / "r.fq"
    with open(fq, "w") as f:
        for i in range(48):
            si = i % 4
            p = int(rng.integers(0, 29000))
            r = list(seqs[si][p:p + 100])
            for _ in range(int(rng.integers(0, 3))):
                j = int(rng.integers(0, 100))
                r[j] = "ACGT"[int(rng.integers(0, 4))]
            read = "".join(r)
            if i % 3 == 0:
                read = "".join(comp[c] for c in reversed(read))
            f.write(f"@r{i}\n{read}\n+\n{'I' * 100}\n")
    mono = str(wd / "mono.cidx")
    blk = str(wd / "blk.cidx")
    cli.main(["build", "-r", mono, "-f", str(fa)])
    # 30k-bp sequences with a 70k block budget -> blocks of 2+2 sequences
    cli.main(["build", "-r", blk, "-f", str(fa), "-B", "70000"])
    return wd, mono, blk, str(fq)


def _body(path):
    return sorted(ln for ln in open(path) if not ln.startswith("@"))


def _sq(path):
    return sorted(ln for ln in open(path) if ln.startswith("@SQ"))


def test_partition_sequences():
    starts = np.array([0, 10, 30, 35, 60])
    assert partition_sequences(starts, 30) == [(0, 2), (2, 4)]
    assert partition_sequences(starts, 60) == [(0, 4)]
    assert partition_sequences(starts, 40) == [(0, 3), (3, 4)]
    with pytest.raises(ValueError):
        partition_sequences(starts, 20)  # one 25-bp sequence won't fit


def test_blocked_meta(workload):
    from columba_jax.index.blocked import load_blocked_meta

    _, _, blk, _ = workload
    meta = load_blocked_meta(blk)
    assert len(meta["blocks"]) == 2
    assert meta["num_seqs"] == 4
    assert sum(b["n"] for b in meta["blocks"]) == meta["n"]


def test_all_mode_parity(workload):
    wd, mono, blk, fq = workload
    out_m, out_b = str(wd / "m_all.sam"), str(wd / "b_all.sam")
    base = ["-f", fq, "-a", "all", "-e", "2", "-m", "edit", "-S", "kuch1",
            "-b", "16"]
    cli.main(["align", "-r", mono, "-o", out_m] + base)
    cli.main(["align", "-r", blk, "-o", out_b] + base)
    assert _sq(out_b) == _sq(out_m)
    assert _body(out_b) == _body(out_m)


def test_best_mode_parity(workload):
    wd, mono, blk, fq = workload
    out_m, out_b = str(wd / "m_best.sam"), str(wd / "b_best.sam")
    base = ["-f", fq, "-a", "best", "-m", "edit", "-S", "kuch1", "-b", "16"]
    cli.main(["align", "-r", mono, "-o", out_m] + base)
    cli.main(["align", "-r", blk, "-o", out_b] + base)
    assert _body(out_b) == _body(out_m)


def test_rhs_parity(workload):
    wd, mono, blk, fq = workload
    out_m, out_b = str(wd / "m.rhs"), str(wd / "b.rhs")
    base = ["-f", fq, "-a", "all", "-e", "1", "-S", "kuch1", "-b", "16"]
    cli.main(["align", "-r", mono, "-o", out_m] + base)
    cli.main(["align", "-r", blk, "-o", out_b] + base)
    assert sorted(open(out_b)) == sorted(open(out_m))


@pytest.fixture(scope="module")
def pe_workload(workload):
    """FR pairs spanning all 4 sequences (fragment 250) + 2 junk pairs."""
    wd, mono, blk, _ = workload
    rng = np.random.default_rng(31)
    seqs = []
    cur = None
    for ln in open(wd / "g.fa"):
        if ln.startswith(">"):
            cur = []
            seqs.append(cur)
        else:
            cur.append(ln.strip())
    seqs = ["".join(s) for s in seqs]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    frag, m = 250, 80
    f1, f2 = wd / "p1.fq", wd / "p2.fq"
    with open(f1, "w") as a, open(f2, "w") as b:
        for i in range(24):
            si = i % 4
            p = int(rng.integers(0, len(seqs[si]) - frag - 1))
            up = list(seqs[si][p:p + m])
            dn = seqs[si][p + frag - m:p + frag]
            dn = [comp[c] for c in reversed(dn)]
            for r in (up, dn):
                for _ in range(int(rng.integers(0, 2))):
                    r[int(rng.integers(0, m))] = "ACGT"[
                        int(rng.integers(0, 4))]
            a.write(f"@p{i}\n{''.join(up)}\n+\n{'I' * m}\n")
            b.write(f"@p{i}\n{''.join(dn)}\n+\n{'I' * m}\n")
        for i in range(24, 26):   # junk
            a.write(f"@p{i}\n{''.join(rng.choice(list('ACGT'), m))}\n+\n"
                    f"{'I' * m}\n")
            b.write(f"@p{i}\n{''.join(rng.choice(list('ACGT'), m))}\n+\n"
                    f"{'I' * m}\n")
    return str(f1), str(f2)


@pytest.mark.parametrize("mode", ["all", "best"])
def test_blocked_pe_parity(workload, pe_workload, mode):
    """PE against the blocked index == PE against the monolithic index
    (occurrences merged across blocks before the single pairing pass)."""
    wd, mono, blk, _ = workload
    f1, f2 = pe_workload
    om = str(wd / f"pe_mono_{mode}.sam")
    ob = str(wd / f"pe_blk_{mode}.sam")
    base = ["-f", f1, "-F", f2, "-a", mode, "--no-inferring",
            "-O", "fr", "-N", "150", "-X", "350", "-b", "16"]
    if mode == "all":
        base += ["-e", "2"]
    assert cli.main(["align", "-r", mono, "-o", om] + base) == 0
    assert cli.main(["align", "-r", blk, "-o", ob] + base) == 0
    assert _sq(om) == _sq(ob)
    assert _body(om) == _body(ob)
