"""Golden-parity harness: compare columba_jax against the reference binary.

Generates a workload, runs both aligners on identical inputs, and diffs
SAM outputs at configurable strictness:

  level "positions": per read, the SET of (strand, pos, NM) must match.
  level "best":      per read, best distance and its position set must match.
  level "cigar":     positions plus CIGAR string and MAPQ must match.

Usage:
  python tools/parity.py --mode all -e 2 --metric edit [--reads 500]
Requires /tmp/colbuild/columba{,_build} (tools/build_reference.sh).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Parity runs belong on the CPU: they compare outputs, not speed, and leave
# the card to whichever process is measuring on it.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REF_BIN = "/tmp/colbuild/columba"
REF_BUILD = "/tmp/colbuild/columba_build"


def make_workload(wd, n=200_000, reads=300, m=100, maxerr=2, seed=1,
                  edits=False, seqs=1):
    """With seqs > 1 the genome splits into that many FASTA records and
    half the reads are sampled to OVERLAP a record boundary (offsets from
    -m+1 to -1 around each junction) — the workload that exercises
    cross-boundary occurrence trimming (reference:
    src/indexinterface.cpp:799-897 findSeqName)."""
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    fa = os.path.join(wd, "genome.fa")
    bounds = [n * j // seqs for j in range(1, seqs)]
    with open(fa, "w") as f:
        cuts = [0] + bounds + [n]
        for si in range(len(cuts) - 1):
            f.write(f">chr{si + 1}\n")
            part = seq[cuts[si]:cuts[si + 1]]
            for i in range(0, len(part), 70):
                f.write(part[i:i + 70] + "\n")
    fq = os.path.join(wd, "reads.fq")
    comp = str.maketrans("ACGT", "TGCA")
    with open(fq, "w") as f:
        for i in range(reads):
            if bounds and i % 2 == 0:
                # straddle a junction at a random overlap
                b = bounds[int(rng.integers(0, len(bounds)))]
                p = int(b - rng.integers(1, m))
            else:
                p = int(rng.integers(0, n - m - maxerr - 1))
            s = list(seq[p:p + m + maxerr])
            for _ in range(int(rng.integers(0, maxerr + 1))):
                j = int(rng.integers(0, m))
                if edits and rng.random() < 0.3:
                    if rng.random() < 0.5:
                        del s[j]
                    else:
                        s.insert(j, "ACGT"[int(rng.integers(0, 4))])
                else:
                    s[j] = "ACGT"[int(rng.integers(0, 4))]
            read = "".join(s[:m])
            if rng.random() < 0.5:
                read = read.translate(comp)[::-1]
            f.write(f"@r{i}\n{read}\n+\n{'I' * m}\n")
    return fa, fq


def make_paired_workload(wd, n=200_000, pairs=200, m=100, maxerr=2, seed=1,
                         edits=False, repeats=0):
    """FR-oriented pairs with inserts ~N(350, 40) in [250, 450].

    With repeats=R > 0, the genome carries R extra copies of its first
    1 kbp (0.5%% divergence) and every pair is sampled from that repeat
    unit, so pairs multi-map with DIFFERENT total distances per locus —
    the workload that separates stratified PE BEST from PE ALL-at-cutoff
    emission (reference: src/searchstrategy.cpp:1091-1179)."""
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, n)
    if repeats:
        unit = base[:1000]
        copies = []
        for _ in range(repeats):
            c = unit.copy()
            nmut = max(1, int(0.005 * len(c)))
            idx = rng.integers(0, len(c), nmut)
            c[idx] = (c[idx] + 1 + rng.integers(0, 3, nmut)) % 4
            copies.append(c)
            copies.append(rng.integers(0, 4, 2000))  # spacer
        base = np.concatenate([base] + copies)
        n = len(base)
    seq = "".join("ACGT"[i] for i in base)
    fa = os.path.join(wd, "genome.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n")
        for i in range(0, n, 70):
            f.write(seq[i:i + 70] + "\n")
    comp = str.maketrans("ACGT", "TGCA")

    def mutate(s):
        s = list(s)
        for _ in range(int(rng.integers(0, maxerr + 1))):
            j = int(rng.integers(0, m))
            if edits and rng.random() < 0.3:
                if rng.random() < 0.5:
                    del s[j]
                else:
                    s.insert(j, "ACGT"[int(rng.integers(0, 4))])
            else:
                s[j] = "ACGT"[int(rng.integers(0, 4))]
        return "".join(s[:m])

    fq1, fq2 = os.path.join(wd, "r1.fq"), os.path.join(wd, "r2.fq")
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(pairs):
            ins = int(np.clip(rng.normal(350, 40), 250, 450))
            lim = (1000 if repeats else n) - ins - maxerr - 1
            p = int(rng.integers(0, lim))
            frag = seq[p:p + ins + maxerr]
            r1 = mutate(frag[:m + maxerr])
            r2 = mutate(frag[-(m + maxerr):][::-1].translate(comp))
            f1.write(f"@p{i}\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * len(r2)}\n")
    return fa, fq1, fq2


def parse_sam(path, with_cigar=False):
    per_read = defaultdict(set)
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        name, flag = f[0], int(f[1])
        if flag & 4:
            per_read[name]  # ensure key exists
            continue
        nm = next((int(x[5:]) for x in f[11:] if x.startswith("NM:i:")), -1)
        mate = flag & 0xC0  # first/second-of-pair bits (0 for SE)
        if with_cigar:
            per_read[name].add((mate, flag & 16, int(f[3]), nm, f[5],
                                int(f[4])))
        else:
            per_read[name].add((mate, flag & 16, int(f[3]), nm))
    return per_read


def run_reference(wd, fa, fq, args, fq2=None):
    idx = os.path.join(wd, "refidx")
    if not os.path.exists(idx + ".meta"):
        subprocess.run([REF_BUILD, "-r", idx, "-f", fa], check=True,
                       capture_output=True)
    out = os.path.join(wd, "ref.sam")
    cmd = [REF_BIN, "-r", idx, "-f", fq, "-o", out, "-a", args.mode,
           "-m", args.metric, "-t", "1", "-p", "uniform", "-S", args.scheme]
    if fq2 is not None:
        cmd += ["-F", fq2, "-nI", "-O", "FR", "-N", "200", "-X", "500"]
    if args.mode == "all":
        cmd += ["-e", str(args.e)]
    elif args.x:
        cmd += ["-x", str(args.x)]
    subprocess.run(cmd, check=True, capture_output=True)
    return out


def run_ours(wd, fa, fq, args, fq2=None):
    from columba_jax import cli

    idx = os.path.join(wd, "ours.cidx")
    if not os.path.exists(os.path.join(idx, "meta.json")):
        cli.main(["build", "-r", idx, "-f", fa])
    out = os.path.join(wd, "ours.sam")
    cmd = ["align", "-r", idx, "-f", fq, "-o", out, "-a", args.mode,
           "-m", args.metric, "-S", args.scheme]
    if fq2 is not None:
        cmd += ["-F", fq2, "--no-inferring", "-O", "fr",
                "-N", "200", "-X", "500"]
    if args.mode == "all":
        cmd += ["-e", str(args.e)]
    elif args.x:
        cmd += ["-x", str(args.x)]
    cli.main(cmd)
    return out


def compare(ref_sam, our_sam, level="positions"):
    ref = parse_sam(ref_sam, with_cigar=(level == "cigar"))
    ours = parse_sam(our_sam, with_cigar=(level == "cigar"))
    names = sorted(set(ref) | set(ours))
    mismatches = []
    for name in names:
        a, b = ref.get(name, set()), ours.get(name, set())
        if level == "best":
            abest = min((x[3] for x in a), default=None)
            bbest = min((x[3] for x in b), default=None)
            if abest != bbest:
                mismatches.append((name, "best", abest, bbest))
                continue
            a = {x for x in a if x[3] == abest}
            b = {x for x in b if x[3] == bbest}
        if a != b:
            mismatches.append((name, "set", sorted(a - b), sorted(b - a)))
    return names, mismatches


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="all", choices=["all", "best"])
    p.add_argument("--metric", default="edit", choices=["edit", "hamming"])
    p.add_argument("-e", type=int, default=2)
    p.add_argument("--scheme", default="kuch1")
    p.add_argument("--reads", type=int, default=300)
    p.add_argument("--genome", type=int, default=200_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--edits", action="store_true")
    p.add_argument("--level", default="positions", choices=["positions", "best", "cigar"])
    p.add_argument("--wd", default="/tmp/parity")
    p.add_argument("--paired", action="store_true")
    p.add_argument("--repeats", type=int, default=0,
                   help="paired workload: extra diverged copies of the "
                        "sampled region so pairs multi-map (PE BEST test)")
    p.add_argument("--seqs", type=int, default=1,
                   help="SE workload: split the genome into this many "
                        "FASTA records and sample half the reads across "
                        "record boundaries (trimming test)")
    p.add_argument("--x", type=int, default=0,
                   help="best-plus-x stratum widening (BEST mode). Known "
                        "divergence: for x>0 the reference emits UNMAPPED "
                        "records for exact-match reads (its stratified "
                        "loop never bins stratum 0 when best=0, "
                        "src/searchstrategy.cpp:676-744); columba_jax "
                        "reports them per the documented best+x semantics, "
                        "so exact-match reads mismatch by design.")
    args = p.parse_args(argv)

    wd = args.wd
    fq2 = None
    if args.paired:
        fa, fq, fq2 = make_paired_workload(
            wd, n=args.genome, pairs=args.reads, maxerr=args.e,
            seed=args.seed, edits=args.edits, repeats=args.repeats)
    else:
        fa, fq = make_workload(wd, n=args.genome, reads=args.reads,
                               maxerr=args.e, seed=args.seed,
                               edits=args.edits, seqs=args.seqs)
    ref_sam = run_reference(wd, fa, fq, args, fq2)
    our_sam = run_ours(wd, fa, fq, args, fq2)
    names, mismatches = compare(ref_sam, our_sam, args.level)
    n_bad = len(mismatches)
    print(f"parity[{args.level}] {args.mode}/{args.metric} e={args.e} "
          f"scheme={args.scheme}: {len(names) - n_bad}/{len(names)} reads agree")
    for mm in mismatches[:10]:
        print("  MISMATCH", mm)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
