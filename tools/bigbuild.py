"""Build + align a GRCh38-scale (>= 3 Gbp) synthetic genome end to end.

Proves the uint32 index path above the old 2^31 ceiling (VERDICT round-1
item 1; reference 64-bit mode: src/definitions.h:69-75,
src/buildindex.cpp:479-538): builds a multi-sequence genome larger than
2^31 bases, indexes it (native SA-IS, chunked packing), loads it on the GPU,
maps sampled reads at k=2 edit, and checks recall/soundness against the
known sampled positions.

Usage:
  python tools/bigbuild.py [--gbp 3.1] [--reads 2000] [--cache /tmp/bigidx]
  python tools/bigbuild.py --gbp 0.3   # quick smoke (below the ceiling)
  python tools/bigbuild.py --gbp 6.0 --blocks   # PAST the 4.29 Gbp uint32
      # ceiling: block-partitioned index (index/blocked.py), aligned
      # through the streamed blocked CLI path, recall vs sampled truth

The genome and index persist under --cache; a second run skips the build
and only measures alignment. Results are appended to the stdout summary for
PERF.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

CHROMO = 1 << 27  # 134 Mbp per synthetic "chromosome"


def synth_genome(n_total: int, seed: int = 20260819) -> tuple[np.ndarray, list, np.ndarray]:
    """Multi-sequence random genome of n_total bases, chunk-generated."""
    rng = np.random.default_rng(seed)
    codes = np.empty(n_total, dtype=np.uint8)
    for lo in range(0, n_total, CHROMO):
        hi = min(lo + CHROMO, n_total)
        codes[lo:hi] = rng.integers(0, 4, size=hi - lo, dtype=np.int64)
    starts = list(range(0, n_total, CHROMO)) + [n_total]
    names = [f"chr{i + 1}" for i in range(len(starts) - 1)]
    return codes, names, np.asarray(starts, dtype=np.int64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--cache", default="/tmp/bigidx")
    ap.add_argument("--sa-sparseness", type=int, default=16)
    ap.add_argument("--skip-align", action="store_true")
    ap.add_argument("--blocks", action="store_true",
                    help="block-partitioned index: the path PAST the 4.29 "
                         "Gbp uint32 ceiling (use with --gbp > 4.3)")
    ap.add_argument("--block-bp", type=int, default=None,
                    help="max bp per block (default: the uint32 MAX_N)")
    args = ap.parse_args()
    if args.blocks:
        return main_blocks(args)

    from columba_jax.index.build import (
        build_index_from_codes, load_index, save_index,
    )

    n_total = int(args.gbp * 1e9)
    os.makedirs(args.cache, exist_ok=True)
    idx_dir = os.path.join(args.cache, f"idx_{n_total}.cidx")
    t0 = time.time()
    if os.path.exists(os.path.join(idx_dir, "meta.json")):
        print(f"[bigbuild] loading cached index {idx_dir}", file=sys.stderr)
        arrays = load_index(idx_dir)
        codes = None
    else:
        print(f"[bigbuild] generating {n_total / 1e9:.2f} Gbp genome",
              file=sys.stderr)
        codes, names, starts = synth_genome(n_total)
        t1 = time.time()
        print(f"[bigbuild] building index (n={n_total}, "
              f"s={args.sa_sparseness})", file=sys.stderr)
        arrays = build_index_from_codes(
            codes, names, starts, sa_sparseness=args.sa_sparseness)
        build_s = time.time() - t1
        print(f"[bigbuild] index built in {build_s:.0f}s "
              f"({n_total / build_s / 1e6:.1f} Mbp/s)", file=sys.stderr)
        save_index(arrays, idx_dir)
        print(f"[bigbuild] saved -> {idx_dir}", file=sys.stderr)

    if args.skip_align:
        return

    # sample reads from the packed text (works for both fresh + cached runs)
    from columba_jax.core import alphabet
    from columba_jax.index.build import unpack_2bit

    rng = np.random.default_rng(7)
    m = args.read_len
    R = args.reads
    n = arrays.n
    starts_pos = rng.integers(0, n - m - 8, size=R)
    # avoid windows crossing a chromosome boundary (sampled truth only)
    starts_pos -= starts_pos % 1  # no-op; boundaries are 2^27-aligned
    bad = (starts_pos % CHROMO) > (CHROMO - m - 8)
    starts_pos[bad] -= m + 8
    reads = np.empty((R, m), dtype=np.uint8)
    words = arrays.text
    for i, s in enumerate(starts_pos):
        w0 = int(s) // 16
        chunk = unpack_2bit(words[w0:w0 + m // 16 + 2], m + 16)
        seq = chunk[int(s) % 16:int(s) % 16 + m].copy()
        nerr = int(rng.poisson(0.01 * m))
        for _ in range(min(nerr, args.k)):
            j = int(rng.integers(0, m))
            seq[j] = (seq[j] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.5:
            seq = alphabet.revcomp(seq)
        reads[i] = seq

    import jax

    from columba_jax.index.fmindex import FMIndex
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    t2 = time.time()
    index = FMIndex.from_arrays(arrays)
    hbm = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in (
        arrays.occ, arrays.rocc, arrays.bwt, arrays.rbwt, arrays.text,
        arrays.sa_samples, arrays.sa_bits, arrays.sa_bits_rank))
    print(f"[bigbuild] device arrays ~{hbm / 1e9:.2f} GB "
          f"(put in {time.time() - t2:.1f}s)", file=sys.stderr)

    scheme = get_scheme("kuch1", args.k)
    t3 = time.time()
    occs, stats = pipeline.match_all(
        index, reads, scheme, metric="edit", switchpoint=4)
    dt = time.time() - t3
    found = np.zeros(R, dtype=bool)
    sound = 0
    for o in occs:
        if abs(o.begin - int(starts_pos[o.read_id])) <= args.k:
            found[o.read_id] = True
            sound += 1
    recall = found.mean()
    print(f"[bigbuild] aligned {R} reads in {dt:.1f}s "
          f"(incl. compile): recall={recall:.4f} "
          f"occs={len(occs)} stats={stats}", file=sys.stderr)
    print(json.dumps({
        "n": int(n), "reads": R, "k": args.k,
        "recall_at_truth": float(recall),
        "total_candidates": stats["total_candidates"],
        "overflow": stats["overflow"],
    }))
    assert recall >= 0.99, f"recall {recall} too low — uint32 path broken?"
    print("[bigbuild] PASS", file=sys.stderr)


def main_blocks(args):
    """Build + align past the 4.29 Gbp single-index ceiling: blocked index
    (index/blocked.py) + the streamed blocked CLI align path, recall checked
    against sampled truth. This is the at-scale run tests/test_blocked.py
    exercises at small scale (reference: 64-bit + Big-BWT regime,
    src/definitions.h:69-75, src/bmove/columba_build_pfp.sh)."""
    from columba_jax.index import blocked
    from columba_jax.index.build import MAX_N, unpack_window

    n_total = int(args.gbp * 1e9)
    os.makedirs(args.cache, exist_ok=True)
    idx_dir = os.path.join(args.cache, f"blk_{n_total}")
    build_s = None
    if not os.path.exists(os.path.join(idx_dir, "meta.json")):
        print(f"[bigbuild] generating {n_total / 1e9:.2f} Gbp genome",
              file=sys.stderr)
        codes, names, starts = synth_genome(n_total)
        t1 = time.time()
        block_bp = args.block_bp or MAX_N
        print(f"[bigbuild] building blocked index (n={n_total}, "
              f"block_bp={block_bp}, s={args.sa_sparseness})",
              file=sys.stderr)
        meta = blocked.build_blocked_from_codes(
            codes, names, starts, idx_dir, max_block_bp=block_bp,
            sa_sparseness=args.sa_sparseness)
        build_s = time.time() - t1
        print(f"[bigbuild] blocked index built in {build_s:.0f}s "
              f"({n_total / build_s / 1e6:.1f} Mbp/s), "
              f"{len(meta['blocks'])} blocks", file=sys.stderr)
        del codes
    meta = blocked.load_blocked_meta(idx_dir)
    assert meta["n"] == n_total, (meta["n"], n_total)
    past_ceiling = n_total > MAX_N
    print(f"[bigbuild] n={n_total} "
          f"({'PAST' if past_ceiling else 'below'} the 4.29 Gbp ceiling), "
          f"{len(meta['blocks'])} blocks", file=sys.stderr)
    if args.skip_align:
        return

    # sample reads with truth from the memory-mapped packed block text
    rng = np.random.default_rng(7)
    m = args.read_len
    R = args.reads
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = blocked.LazyBlockText(idx_dir, meta)
    starts_pos = rng.integers(0, n_total - m - 8, size=R)
    bad = (starts_pos % CHROMO) > (CHROMO - m - 8)
    starts_pos[bad] -= m + 8
    from columba_jax.core import alphabet

    fq = os.path.join(args.cache, f"blk_{n_total}_reads.fq")
    truth = []
    with open(fq, "w") as f:
        for i, s in enumerate(starts_pos):
            seq = np.array(text[int(s):int(s) + m])
            nerr = int(rng.poisson(0.01 * m))
            for _ in range(min(nerr, args.k)):
                j = int(rng.integers(0, m))
                seq[j] = (seq[j] + 1 + rng.integers(0, 3)) % 4
            if rng.random() < 0.5:
                seq = np.asarray(alphabet.revcomp(seq))
            f.write(f"@r{i}\n{lut[seq].tobytes().decode()}\n+\n{'I' * m}\n")
            truth.append(int(s))

    from columba_jax import cli

    out = os.path.join(args.cache, f"blk_{n_total}_out.sam")
    t3 = time.time()
    rc = cli.main(["align", "-r", idx_dir, "-f", fq, "-o", out,
                   "-e", str(args.k), "-a", "all", "-m", "edit",
                   "-S", "kuch1", "-b", "4096", "-v"])
    dt = time.time() - t3
    assert rc == 0

    # recall: primary/secondary position within k of the sampled origin
    import re

    seq_off = {}  # seq name -> global offset
    from columba_jax.index.blocked import make_view

    view = make_view(idx_dir, meta)
    for name, off in zip(view.seq_names, view.seq_starts[:-1]):
        seq_off[name] = int(off)
    found = np.zeros(R, dtype=bool)
    for line in open(out):
        if line.startswith("@"):
            continue
        fld = line.split("\t")
        if fld[2] == "*":
            continue
        ri = int(fld[0][1:])
        gpos = seq_off[fld[2]] + int(fld[3]) - 1
        if abs(gpos - truth[ri]) <= args.k:
            found[ri] = True
    recall = found.mean()
    res = {
        "n": n_total, "blocks": len(meta["blocks"]),
        "past_uint32_ceiling": bool(past_ceiling),
        "reads": R, "k": args.k, "recall_at_truth": float(recall),
        "align_secs": round(dt, 1),
        "align_reads_per_sec": round(R / dt, 1),
    }
    if build_s is not None:
        res["build_secs"] = round(build_s, 1)
    print(json.dumps(res))
    assert recall >= 0.99, f"recall {recall} too low — blocked path broken?"
    print("[bigbuild] PASS (blocked)", file=sys.stderr)


if __name__ == "__main__":
    main()
