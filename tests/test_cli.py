"""CLI option coverage: the reference's aligner flags on small workloads.

Covers the option surface the other suites don't reach: -K (k-mer size),
-b, -c/-d scheme sources, -nC, -l/-v, -D plumbing
(reference: src/parameters/alignparameters.cpp).
"""

import os

import numpy as np
import pytest

from columba_jax import cli

SCHEMES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "schemes")


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    wd = tmp_path_factory.mktemp("cliwl")
    rng = np.random.default_rng(11)
    seq = "".join(rng.choice(list("ACGT"), 40000))
    fa = wd / "g.fa"
    fa.write_text(">c1\n" + seq + "\n")
    idx = str(wd / "i.cidx")
    cli.main(["build", "-r", idx, "-f", str(fa)])
    fq = wd / "r.fq"
    with open(fq, "w") as f:
        for i in range(16):
            p = int(rng.integers(0, 39000))
            f.write(f"@r{i}\n{seq[p:p+100]}\n+\n{'I' * 100}\n")
    return wd, idx, str(fq)


def _body(path):
    return [ln for ln in open(path) if not ln.startswith("@")]


def test_kmer_size_and_batch(workload):
    wd, idx, fq = workload
    out = str(wd / "o1.sam")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out, "-a", "all",
              "-e", "1", "-K", "6", "-b", "8"])
    assert len(_body(out)) == 16


def test_no_cigar_and_logfile(workload):
    wd, idx, fq = workload
    out = str(wd / "o2.sam")
    log = str(wd / "run.log")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out, "-a", "all",
              "-e", "1", "-nC", "-l", log, "-v", "-t", "2", "-R"])
    assert all(ln.split("\t")[5] == "*" for ln in _body(out))
    assert os.path.getsize(log) > 0


def test_custom_scheme_folder(workload):
    wd, idx, fq = workload
    out = str(wd / "o3.sam")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out, "-a", "all",
              "-e", "1", "-c", os.path.join(SCHEMES, "kuch_k+1")])
    assert len(_body(out)) == 16


def test_dynamic_selection_folder(workload):
    wd, idx, fq = workload
    multi = wd / "multi" / "1"
    multi.mkdir(parents=True)
    text = open(os.path.join(SCHEMES, "kuch_k+1", "1", "searches.txt")).read()
    (multi / "scheme1.txt").write_text(text)
    (multi / "scheme2.txt").write_text(text)
    out = str(wd / "o4.sam")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out, "-a", "all",
              "-e", "1", "-d", str(wd / "multi")])
    assert len(_body(out)) == 16


def test_discordant_flag_plumbing(workload):
    from columba_jax.search import paired

    # default matches the reference: no discordant pairing without -D
    assert paired.PairedConfig().discordant is False


def test_seeded_replacement_matches_reference_rng():
    """Replacement seed string is bit-exact with libstdc++
    minstd_rand(42) + uniform_int_distribution(0,3) (verified against a
    compiled C++ probe)."""
    from columba_jax.index.build import _minstd_uniform4

    assert "".join(map(str, _minstd_uniform4(24))) == \
        "021123220032103133221331"


def test_seeded_replacement_runs_cycle(tmp_path):
    from columba_jax.core import alphabet
    from columba_jax.index.build import _minstd_uniform4, preprocess_fasta

    fa = tmp_path / "n.fa"
    fa.write_text(">c\nAANNNNNNCNNA\n")
    codes, _, _ = preprocess_fasta([str(fa)], seed_length=100)
    seed = _minstd_uniform4(100)
    # each run restarts the seed cycle (replaceNonACGTWithSeed resets)
    np.testing.assert_array_equal(codes[2:8], seed[:6])
    np.testing.assert_array_equal(codes[9:11], seed[:2])
    assert codes[8] == alphabet.encode("C")[0]


def test_sa_subsample_equivalent(tmp_path):
    """Aligning with -s F on a fine-sampled index = aligning on an index
    built at F."""
    from columba_jax.index.build import build_index_from_codes, subsample_sa

    rng = np.random.default_rng(2)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    fine = build_index_from_codes(g, sa_sparseness=1)
    sub = subsample_sa(fine, 8)
    direct = build_index_from_codes(g, sa_sparseness=8)
    np.testing.assert_array_equal(sub.sa_samples, direct.sa_samples)
    np.testing.assert_array_equal(sub.sa_bits, direct.sa_bits)
    np.testing.assert_array_equal(sub.sa_bits_rank, direct.sa_bits_rank)


def test_build_all_sparseness_and_align_s(tmp_path):
    rng = np.random.default_rng(13)
    seq = "".join(rng.choice(list("ACGT"), 20000))
    fa = tmp_path / "g.fa"
    fa.write_text(">c1\n" + seq + "\n")
    lst = tmp_path / "fastas.txt"
    lst.write_text(str(fa) + "\n")
    idx = str(tmp_path / "i.cidx")
    cli.main(["build", "-r", idx, "-F", str(lst), "-a"])
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(8):
            p = int(rng.integers(0, 19000))
            f.write(f"@r{i}\n{seq[p:p+100]}\n+\n{'I' * 100}\n")
    out = str(tmp_path / "o.sam")
    cli.main(["align", "-r", idx, "-f", str(fq), "-o", out, "-a", "all",
              "-e", "0", "-s", "32"])
    assert len(_body(out)) == 8


def test_xa_rhs_and_trim(workload):
    """-XA folds secondaries into the primary's XA tag; .rhs output emits
    read-hit summaries; -T trims reads before aligning."""
    import os

    wd, idx, fq = workload
    wd = str(wd)

    out_xa = os.path.join(wd, "xa.sam")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out_xa, "-a", "all",
              "-e", "2", "-XA"])
    body = [l for l in open(out_xa) if not l.startswith("@")]
    assert body and all(
        "\tXA:Z:" in l or l.split("\t")[1] in ("0", "16", "4")
        for l in body)
    # XA mode: exactly one record per read
    names = [l.split("\t")[0] for l in body]
    assert len(names) == len(set(names))

    out_rhs = os.path.join(wd, "out.rhs")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out_rhs, "-a", "all",
              "-e", "2"])
    rhs = [l for l in open(out_rhs) if "\t" in l]
    assert rhs and all("(" in l.split("\t")[1] for l in rhs)

    out_trim = os.path.join(wd, "trim.sam")
    cli.main(["align", "-r", idx, "-f", fq, "-o", out_trim, "-a", "all",
              "-e", "2", "-T", "0-60"])
    tb = [l for l in open(out_trim) if not l.startswith("@")
          and l.split("\t")[1] != "4"]
    assert tb and all(len(l.split("\t")[9]) == 60 for l in tb)


def test_paired_end_variable_read_lengths(workload):
    """PE pairs bucketed by (len1, len2): mixed-length input maps and the
    SAM stays in input order (reference streams any record length,
    src/fastq.cpp:43-241)."""
    from columba_jax.core import alphabet
    from columba_jax.io import fastq

    wd, idx, _ = workload
    rng = np.random.default_rng(23)
    genome = next(iter(fastq.parse_reads(str(wd / "g.fa")))).codes
    i2c = "ACGT"
    n, frag = 12, 280
    with open(wd / "p1.fq", "w") as f1, open(wd / "p2.fq", "w") as f2:
        for i in range(n):
            l1 = 80 if i % 3 == 0 else 100
            l2 = 70 if i % 5 == 0 else 100
            s = int(rng.integers(0, len(genome) - frag - 1))
            up = "".join(i2c[c] for c in genome[s:s + l1])
            dn = "".join(
                i2c[c] for c in alphabet.revcomp(genome[s + frag - l2:s + frag]))
            f1.write(f"@p{i}/1\n{up}\n+\n{'I' * l1}\n")
            f2.write(f"@p{i}/2\n{dn}\n+\n{'I' * l2}\n")
    out = str(wd / "pe_var.sam")
    rc = cli.main(["align", "-r", idx, "-f", str(wd / "p1.fq"),
                   "-F", str(wd / "p2.fq"), "-o", out, "-a", "all",
                   "-e", "1", "-b", "8", "--no-inferring",
                   "-N", "0", "-X", "500"])
    assert rc == 0
    lines = _body(out)
    names = [ln.split("\t")[0].split("/")[0] for ln in lines]
    assert set(names) == {f"p{i}" for i in range(n)}
    firsts = {}
    for j, nm in enumerate(names):
        firsts.setdefault(nm, j)
    order = [firsts[f"p{i}"] for i in range(n)]
    assert order == sorted(order)
    proper = sum(1 for ln in lines if int(ln.split("\t")[1]) & 2)
    assert proper >= 2 * n - 2


def test_paired_best_rows_vs_python_parity(workload, monkeypatch):
    """PE BEST through the CLI: the array-native rows path (native parse +
    PERowsBest + native emit) must produce byte-identical SAM to the
    pure-Python object path (COLUMBA_JAX_NO_NATIVE)."""
    from columba_jax.core import alphabet
    from columba_jax.io import fastq

    wd, idx, _ = workload
    rng = np.random.default_rng(77)
    genome = next(iter(fastq.parse_reads(str(wd / "g.fa")))).codes
    i2c = "ACGT"
    m, frag, n = 64, 220, 40
    with open(wd / "b1.fq", "w") as f1, open(wd / "b2.fq", "w") as f2:
        for i in range(n):
            s = int(rng.integers(0, len(genome) - frag - 1))
            r1 = genome[s:s + m].copy()
            r2 = alphabet.revcomp(genome[s + frag - m:s + frag]).copy()
            for r in (r1, r2):        # noise incl. some garbage pairs
                for _ in range(int(rng.integers(0, 3))):
                    r[int(rng.integers(0, m))] = rng.integers(0, 4)
            if i % 9 == 0:
                r1 = rng.integers(0, 4, m)
            f1.write(f"@b{i}\n{''.join(i2c[c] for c in r1)}\n+\n{'I'*m}\n")
            f2.write(f"@b{i}\n{''.join(i2c[c] for c in r2)}\n+\n{'I'*m}\n")
    argv = ["align", "-r", idx, "-f", str(wd / "b1.fq"),
            "-F", str(wd / "b2.fq"), "-a", "best", "-b", "16",
            "--no-inferring", "-N", "100", "-X", "320"]
    out_n = str(wd / "pe_native.sam")
    rc = cli.main(argv + ["-o", out_n])
    assert rc == 0
    # pure-Python path in a subprocess (native kill switch is read at
    # module import time by cached loaders)
    import subprocess
    import sys

    out_p = str(wd / "pe_python.sam")
    env = dict(os.environ, COLUMBA_JAX_NO_NATIVE="1")
    subprocess.run([sys.executable, "-m", "columba_jax.cli"]
                   + argv + ["-o", out_p], check=True, env=env,
                   capture_output=True, timeout=600)
    assert _body(out_n) == _body(out_p)
