"""End-to-end benchmark matrix on the GPU — the BASELINE.md plan.

Runs the COMPLETE CLI pipeline (FASTQ -> SAM on disk) for a matrix of
configs that actually exercise the different engine phases (exact path,
Hamming band, deep edit band, BEST strata, dynamic selection, paired-end),
each twice (warmup populates the jit + persistent compile caches; the
second run is reported). Optionally times the reference binary on the same
inputs for context (single thread; this box has 4 cores, the reference
scales ~linearly with -t).

Usage:
  python tools/bench_matrix.py [--reads 100000] [--out matrix.md]
  python tools/bench_matrix.py --configs exact_k0,edit4_all  # subset

Writes a markdown table (stdout + --out) with reads/s, % mapped, and the
band-phase proof counter (searches started > 0 where claimed).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stderr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

CACHE = "/tmp/columba_jax_bench"
REF_BIN = "/tmp/colbuild/columba"

CONFIGS = {
    # id: (mode, metric, scheme, k_or_None, paired, band_expected[, itv])
    # On the (random-genome) bench workload every read resolves via
    # exact-prefix + in-text crossover at the default switchpoint — the
    # *_band rows disable the crossover (-i 0) so the frontier band phase
    # demonstrably carries the full load (searches_started > 0).
    "exact_k0":    dict(mode="all", metric="edit", scheme="kuch1", k=0,
                        paired=False, band=False),
    "ham2_pigeon": dict(mode="all", metric="hamming", scheme="pigeon", k=2,
                        paired=False, band=False),
    "ham2_band":   dict(mode="all", metric="hamming", scheme="pigeon", k=2,
                        paired=False, band=True, itv=0),
    "edit2_all":   dict(mode="all", metric="edit", scheme="kuch1", k=2,
                        paired=False, band=False),
    "edit4_all":   dict(mode="all", metric="edit", scheme="kuch1", k=4,
                        paired=False, band=False),
    "edit4_band":  dict(mode="all", metric="edit", scheme="kuch1", k=4,
                        paired=False, band=True, itv=0),
    "best_dyn":    dict(mode="best", metric="edit", scheme="columba", k=None,
                        paired=False, band=False),
    "pe_best":     dict(mode="best", metric="edit", scheme="kuch1", k=None,
                        paired=True, band=False),
}


def pan_genome():
    """Repeat-rich pan-genome: 20 near-identical haplotypes (0.1% SNP
    divergence) of a 6.4 Mbp base = 128 Mbp total. Same scale as the
    random bench genome, but with the massive repeat structure (every
    locus occurs ~20x) that stresses locate fan-out, spill retries and
    crossover junk — the regime the reference's reproduction workloads
    (GRCh38) pin (further_info/result_reproduction/README.md:14-75)."""
    import numpy as np

    import bench

    gpath = os.path.join(CACHE, "pan_genome.npy")
    if os.path.exists(gpath):
        return np.load(gpath)
    base_n = bench.GENOME_N // 20
    rng = np.random.default_rng(20260820)
    base = rng.integers(0, 4, size=base_n).astype(np.uint8)
    haps = [base]
    for _ in range(19):
        h = base.copy()
        snps = rng.random(base_n) < 0.001
        h[snps] = (h[snps] + rng.integers(1, 4, snps.sum())) % 4
        haps.append(h)
    genome = np.concatenate(haps)
    np.save(gpath, genome)
    return genome


def ensure_workload(n_reads: int, pan: bool = False):
    """Reuse bench.py's cached genome/index; write per-matrix FASTQs."""
    import numpy as np

    import bench

    if pan:
        genome = pan_genome()
        idx_dir = os.path.join(CACHE, "idx_pan_s1.cidx")
        if not os.path.exists(os.path.join(idx_dir, "meta.json")):
            from columba_jax.index.build import (
                build_index_from_codes, save_index)

            save_index(build_index_from_codes(genome, sa_sparseness=1),
                       idx_dir)
    else:
        genome, _ = bench.build_workload()
        bench.build_index_cached(genome)
    from columba_jax.core import alphabet

    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    m = bench.READ_LEN
    rng = np.random.default_rng(8)
    tag = "pan_" if pan else ""

    def sample(R, err):
        starts = rng.integers(0, len(genome) - m - 400, size=R)
        reads = genome[starts[:, None] + np.arange(m)[None, :]].copy()
        errs = rng.random((R, m)) < err
        reads = np.where(errs, (reads + rng.integers(1, 4, (R, m))) % 4,
                         reads)
        flip = rng.random(R) < 0.5
        reads[flip] = alphabet.revcomp(reads[flip], axis=-1)
        return starts, reads

    fq = os.path.join(CACHE, f"matrix_{tag}{n_reads}.fq")
    if not os.path.exists(fq):
        _, reads = sample(n_reads, 0.01)
        with open(fq, "w") as f:
            q = "I" * m
            for i in range(n_reads):
                f.write(f"@r{i}\n{lut[reads[i]].tobytes().decode()}\n+\n{q}\n")
    fq1 = os.path.join(CACHE, f"matrix_{tag}{n_reads}_1.fq")
    fq2 = os.path.join(CACHE, f"matrix_{tag}{n_reads}_2.fq")
    if not (os.path.exists(fq1) and os.path.exists(fq2)):
        n_pairs = n_reads // 2
        starts = rng.integers(0, len(genome) - 500, size=n_pairs)
        ins = np.clip(rng.normal(350, 40, n_pairs), 250, 450).astype(int)
        q = "I" * m
        with open(fq1, "w") as f1, open(fq2, "w") as f2:
            for i in range(n_pairs):
                s, L = int(starts[i]), int(ins[i])
                frag = genome[s:s + L]
                r1 = frag[:m]
                r2 = np.asarray(alphabet.revcomp(frag[-m:]))
                f1.write(f"@p{i}\n{lut[r1].tobytes().decode()}\n+\n{q}\n")
                f2.write(f"@p{i}\n{lut[r2].tobytes().decode()}\n+\n{q}\n")
    return fq, fq1, fq2


def run_config(name: str, spec: dict, fq, fq1, fq2, batch: int,
               pan: bool = False):
    from columba_jax import cli

    idx = os.path.join(CACHE, "idx_pan_s1.cidx" if pan else "idx_s1.cidx")
    out = os.path.join(CACHE, f"matrix_{name}.sam")
    cmd = ["align", "-r", idx, "-o", out, "-a", spec["mode"],
           "-m", spec["metric"], "-S", spec["scheme"], "-b", str(batch),
           "-v"]
    if "itv" in spec:
        cmd += ["-i", str(spec["itv"])]
    if spec["paired"]:
        cmd += ["-f", fq1, "-F", fq2, "--no-inferring", "-O", "fr",
                "-N", "200", "-X", "500"]
        n_reads = 2 * sum(1 for _ in open(fq1)) // 4
    else:
        cmd += ["-f", fq]
        n_reads = sum(1 for _ in open(fq)) // 4
    if spec["k"] is not None:
        cmd += ["-e", str(spec["k"])]

    def once():
        buf = io.StringIO()
        t0 = time.time()
        with redirect_stderr(buf):
            rc = cli.main(list(cmd))
        dt = time.time() - t0
        assert rc == 0
        return dt, buf.getvalue()

    once()                      # warmup (jit caches)
    dt, log = once()            # timed
    mapped = _grep(log, r"Percentage (?:of pairs|reads) mapped: ([\d.]+)%")
    searches = _grep(log, r"Searches started[^:]*: (\d+)")
    retries = _grep(log, r"Lossless spill retries[^:]*: (\d+)")
    return dict(name=name, reads=n_reads, secs=round(dt, 1),
                rps=round(n_reads / dt, 1),
                pct_mapped=mapped, searches_started=searches,
                retries=retries, band=spec["band"])


def _grep(text, pat):
    m = re.findall(pat, text)
    return m[-1] if m else None


def ensure_ref_pan_index() -> bool:
    """Build the reference index for the pan genome (once, cached)."""
    wd = os.path.join(CACHE, "refpan")
    if os.path.exists(os.path.join(wd, "idx.meta")):
        return True
    builder = os.path.join(os.path.dirname(REF_BIN), "columba_build")
    if not os.path.exists(builder):
        return False
    import numpy as np

    from columba_jax.core import alphabet

    os.makedirs(wd, exist_ok=True)
    fa = os.path.join(wd, "genome.fa")
    if not os.path.exists(fa):
        genome = pan_genome()
        with open(fa, "w") as f:
            f.write(">pan\n")
            seq = alphabet.decode(np.asarray(genome))
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    try:
        subprocess.run([builder, "-r", os.path.join(wd, "idx"), "-f", fa],
                       check=True, timeout=3600, capture_output=True)
    except Exception as e:
        print(f"[matrix] reference pan build failed: {e}", file=sys.stderr)
        return False
    return True


def run_reference(name: str, spec: dict, fq, fq1, fq2,
                  pan: bool = False) -> float | None:
    if not os.path.exists(REF_BIN):
        return None
    wd = os.path.join(CACHE, "refpan" if pan else "ref")
    idx = os.path.join(wd, "idx")
    if not os.path.exists(idx + ".meta"):
        return None
    out = os.path.join(wd, f"matrix_{name}.sam")
    cmd = [REF_BIN, "-r", idx, "-o", out, "-a", spec["mode"],
           "-m", spec["metric"], "-t", "1", "-p", "uniform"]
    if "itv" in spec:
        cmd += ["-i", str(spec["itv"])]
    if spec["scheme"] != "columba":
        cmd += ["-S", spec["scheme"]]
    if spec["paired"]:
        cmd += ["-f", fq1, "-F", fq2, "-nI", "-O", "FR",
                "-N", "200", "-X", "500"]
        n_reads = 2 * sum(1 for _ in open(fq1)) // 4
    else:
        cmd += ["-f", fq]
        n_reads = sum(1 for _ in open(fq)) // 4
    if spec["k"] is not None:
        cmd += ["-e", str(spec["k"])]
    try:
        t0 = time.time()
        subprocess.run(cmd, check=True, timeout=14400, capture_output=True)
        return n_reads / (time.time() - t0)
    except Exception as e:
        print(f"[matrix] reference {name} failed: {e}", file=sys.stderr)
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--no-reference", action="store_true")
    ap.add_argument("--pan", action="store_true",
                    help="repeat-rich pan-genome workload (20x0.1%% "
                    "haplotypes) instead of the random genome")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from columba_jax import compile_cache

    compile_cache.enable()
    fq, fq1, fq2 = ensure_workload(args.reads, pan=args.pan)
    if args.pan and not args.no_reference:
        ensure_ref_pan_index()
    rows = []
    for name in args.configs.split(","):
        spec = CONFIGS[name]
        print(f"[matrix] running {name} ...", file=sys.stderr)
        r = run_config(name, spec, fq, fq1, fq2, args.batch, pan=args.pan)
        if not args.no_reference:
            print(f"[matrix] reference {name} ...", file=sys.stderr)
            ref = run_reference(name, spec, fq, fq1, fq2, pan=args.pan)
            r["ref_rps_1t"] = round(ref, 1) if ref else None
            r["vs_ref_1t"] = (round(r["rps"] / ref, 2) if ref else None)
        rows.append(r)
        print(json.dumps(r), file=sys.stderr)

    hdr = ("| config | reads | GPU reads/s | ref reads/s (1 thread) | "
           "speedup | % mapped | searches started | spill retries |\n"
           "|---|---|---|---|---|---|---|---|\n")
    body = "".join(
        f"| {r['name']} | {r['reads']} | {r['rps']:,} | "
        f"{r.get('ref_rps_1t') or '—'} | {r.get('vs_ref_1t') or '—'}x | "
        f"{r['pct_mapped']}% | {r['searches_started']} | "
        f"{r.get('retries') or 0} |\n"
        for r in rows)
    table = hdr + body
    print(table)
    for r in rows:
        if r["band"] and not int(r["searches_started"] or 0):
            print(f"[matrix] WARNING: {r['name']} claimed band phase but "
                  "searches_started == 0", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)


if __name__ == "__main__":
    main()
