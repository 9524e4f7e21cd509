"""End-to-end smoke check of the read mapper on an NVIDIA GPU.

Builds a seeded genome at the scale of the upstream project's smoke dataset
(two human chr19 haplotypes, BASELINE.md), indexes it with ``cli build`` and
maps reads through ``cli align`` in the modes users run: ALL at k=2, BEST at
the upstream defaults, paired-end, and the run-length-compressed index.
Every result is checked against the sampled truth, and the library's ALL
path against a brute-force oracle run on the card over the whole genome.

Usage:
  python chip_smoke.py              # one card, every phase
  python chip_smoke.py --cards 4    # the four-card mesh phase only

Prints one line per phase with its seconds and checks, the cards' name and
power limit, and as the last line one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``. Exits non-zero,
without that line, when no GPU is present or any phase fails. The genome,
reads and indexes live under ``.smoke/seed<seed>/`` in the checkout; a
second run reuses the indexes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HAP_BP = 58_617_616          # GRCh38 chr19; the smoke data are 2 haplotypes
HAP_DIVERGENCE = 0.001       # second haplotype vs the first
# N runs of the first haplotype as (start, length) fractions of HAP_BP:
# telomeres of 10 kbp and two internal gaps of 50 and 100 kbp
N_RUNS = ((0.0, 1.706e-4), (0.42, 8.53e-4), (0.71, 1.706e-3),
          (1.0 - 1.706e-4, 1.706e-4))
UNPLACED_BP = (150_000, 80_000)  # two small unplaced contigs
SUB_RATE = 0.01              # read substitutions per base
INDEL_PROB = 0.1             # chance a read carries one 1-base indel
SLACK = 5                    # bases of position slack for indel reads
K = 2                        # ALL-mode distance; recall is checked at <= K


# --------------------------------------------------------------------------
# Pure helpers: genome, reads, FASTA/FASTQ/SAM, truth checks
# --------------------------------------------------------------------------

def _diverge(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Copy of seq with `rate` events per base: 90% substitutions, 10%
    1-3 bp indels. N bases stay N."""
    out = seq.copy()
    n_ev = int(rng.binomial(len(seq), rate))
    pos = np.unique(rng.integers(0, len(seq), n_ev))
    is_sub = rng.random(len(pos)) < 0.9
    sub = pos[is_sub]
    sub = sub[out[sub] < 4]
    out[sub] = (out[sub] + rng.integers(1, 4, len(sub))) % 4
    indel = pos[~is_sub]
    half = len(indel) // 2
    dels, ins = indel[:half], indel[half:]
    ins = ins[out[ins] < 4]
    ins_len = rng.integers(1, 4, len(ins))
    del_len = rng.integers(1, 4, len(dels))
    drop = np.unique(np.concatenate(
        [d + np.arange(L) for d, L in zip(dels, del_len)] or [[]]
    ).astype(np.int64))
    drop = drop[drop < len(out)]
    keep = np.ones(len(out), bool)
    keep[drop] = False
    # insertions before deletions are applied on original coordinates
    ins_at = np.repeat(ins, ins_len)
    ins_val = rng.integers(0, 4, len(ins_at)).astype(np.uint8)
    out = np.insert(out, ins_at, ins_val)
    keep = np.insert(keep, ins_at, True)
    return out[keep]


def make_genome(seed: int, hap_bp: int = HAP_BP):
    """Seeded two-haplotype genome plus unplaced contigs.

    Returns (names, seqs) with uint8 codes, 4 = N."""
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 4, hap_bp, dtype=np.uint8)
    for f0, fl in N_RUNS:
        a = int(f0 * hap_bp)
        h1[a:a + max(1, int(fl * hap_bp))] = 4
    h2 = _diverge(rng, h1, HAP_DIVERGENCE)
    scale = hap_bp / HAP_BP
    un = [rng.integers(0, 4, max(1, int(L * scale)), dtype=np.uint8)
          for L in UNPLACED_BP]
    names = ["chr19_hap1", "chr19_hap2", "chrUn_a", "chrUn_b"]
    return names, [h1, h2] + un


def write_fasta(path: str, names, seqs, width: int = 80) -> None:
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n".encode())
            full = len(s) // width * width
            body = np.empty((full // width, width + 1), np.uint8)
            body[:, :width] = lut[s[:full]].reshape(-1, width)
            body[:, width] = ord("\n")
            f.write(body.tobytes())
            if full < len(s):
                f.write(lut[s[full:]].tobytes() + b"\n")


def _sample_windows(rng, seqs, num: int, span: int):
    """(contig, start) of `num` N-free windows of length span, contigs
    weighted by length."""
    lens = np.array([len(s) for s in seqs], np.int64)
    ok = lens > span
    w = np.where(ok, lens, 0) / np.where(ok, lens, 0).sum()
    ctg = rng.choice(len(seqs), size=num, p=w)
    start = (rng.random(num) * (lens[ctg] - span)).astype(np.int64)
    for i in range(num):
        s = seqs[ctg[i]]
        while (s[start[i]:start[i] + span] == 4).any():
            start[i] = rng.integers(0, len(s) - span)
    return ctg, start


def _mutate(rng, seg: np.ndarray, m: int):
    """First m bases of seg with substitutions at SUB_RATE and, with
    INDEL_PROB, one 1-base indel away from the ends. Returns (read,
    edits)."""
    edits = 0
    if rng.random() < INDEL_PROB:
        i = int(rng.integers(5, m - 5))
        if rng.random() < 0.5:
            seg = np.delete(seg, i)
        else:
            seg = np.insert(seg, i, rng.integers(0, 4))
        edits += 1
    read = seg[:m].copy()
    subs = np.nonzero(rng.random(m) < SUB_RATE)[0]
    read[subs] = (read[subs] + rng.integers(1, 4, len(subs))) % 4
    return read, edits + len(subs)


def sample_reads(seed: int, seqs, num: int, m: int):
    """Seeded single-end reads with truth.

    Returns (reads (num, m) uint8, truth dict of arrays ctg, pos (0-based
    leftmost reference base), strand (1 = reverse complement), edits)."""
    from columba_jax.core import alphabet

    rng = np.random.default_rng(seed)
    ctg, start = _sample_windows(rng, seqs, num, m + 2)
    reads = np.empty((num, m), np.uint8)
    edits = np.empty(num, np.int64)
    strand = (rng.random(num) < 0.5).astype(np.int64)
    for i in range(num):
        seg = seqs[ctg[i]][start[i]:start[i] + m + 2]
        r, edits[i] = _mutate(rng, seg, m)
        reads[i] = alphabet.revcomp(r) if strand[i] else r
    return reads, dict(ctg=ctg, pos=start, strand=strand, edits=edits)


def sample_pairs(seed: int, seqs, num: int, m: int, insert_mean: int = 300,
                 insert_sd: int = 30):
    """Seeded FR pairs with truth per mate (as sample_reads, keys suffixed
    1 and 2)."""
    from columba_jax.core import alphabet

    rng = np.random.default_rng(seed)
    ins = np.clip(rng.normal(insert_mean, insert_sd, num).astype(np.int64),
                  m + 10, insert_mean + 4 * insert_sd)
    ctg, start = _sample_windows(rng, seqs, num, int(ins.max()) + 2)
    r1 = np.empty((num, m), np.uint8)
    r2 = np.empty((num, m), np.uint8)
    t = {k: np.empty(num, np.int64) for k in
         ("pos1", "pos2", "strand1", "strand2", "edits1", "edits2")}
    flip = rng.random(num) < 0.5
    for i in range(num):
        s = seqs[ctg[i]]
        a = start[i]
        b = a + ins[i] - m                  # leftmost base of the far mate
        left, e_l = _mutate(rng, s[a:a + m + 2], m)
        right, e_r = _mutate(rng, s[b:b + m + 2], m)
        if not flip[i]:   # mate 1 forward at a, mate 2 reverse at b
            r1[i], r2[i] = left, alphabet.revcomp(right)
            p1, p2, s1, s2, e1, e2 = a, b, 0, 1, e_l, e_r
        else:             # fragment from the reverse strand
            r1[i], r2[i] = alphabet.revcomp(right), left
            p1, p2, s1, s2, e1, e2 = b, a, 1, 0, e_r, e_l
        t["pos1"][i], t["pos2"][i] = p1, p2
        t["strand1"][i], t["strand2"][i] = s1, s2
        t["edits1"][i], t["edits2"][i] = e1, e2
    t["ctg"] = ctg
    return r1, r2, t


def write_fastq(path: str, reads: np.ndarray, prefix: str = "r") -> None:
    lut = np.frombuffer(b"ACGTN", np.uint8)
    qual = "I" * reads.shape[1]
    seqs = lut[reads]
    with open(path, "w") as f:
        f.writelines(f"@{prefix}{i}\n{seqs[i].tobytes().decode()}\n+\n"
                     f"{qual}\n" for i in range(len(reads)))


def parse_sam(path: str) -> dict:
    """qname -> list of (flag, rname, pos1, nm) of mapped records."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.rstrip("\n").split("\t")
            flag = int(c[1])
            if flag & 4:
                continue
            nm = next((int(x[5:]) for x in c[11:] if x.startswith("NM:i:")),
                      -1)
            out.setdefault(c[0], []).append((flag, c[2], int(c[3]), nm))
    return out


def origin_found(recs, rname: str, pos0: int, strand: int,
                 mate_bit: int = 0) -> bool:
    """Whether a record of this read (or mate: 0x40 / 0x80) lies at its
    origin: same contig and strand, leftmost base within SLACK."""
    for flag, rn, pos1, _ in recs:
        if mate_bit and not flag & mate_bit:
            continue
        if (rn == rname and bool(flag & 16) == bool(strand)
                and abs(pos1 - 1 - pos0) <= SLACK):
            return True
    return False


def semiglobal_ed(read: np.ndarray, window: np.ndarray) -> int:
    """Least edit distance of read against any substring of window."""
    prev = np.zeros(len(window) + 1, np.int64)
    cols = np.arange(1, len(window) + 1)
    for j, c in enumerate(read, 1):
        best = np.minimum(prev[:-1] + (window != c), prev[1:] + 1)
        left = np.minimum.accumulate(best - cols) + cols
        prev = np.concatenate([[j], np.minimum(best, left)])
    return int(prev.min())


def check_recall(sam: dict, names, seqs, reads, truth, qnames,
                 strict: bool) -> dict:
    """Recall of reads with <= K injected edits at their origin.

    strict (ALL mode): the origin must be reported. Otherwise (BEST) a read
    may instead report only placements strictly better than its origin's
    true distance, which a host DP over the origin window decides."""
    from columba_jax.core import alphabet

    checked = found = better = 0
    missed = []
    for i, q in enumerate(qnames):
        if truth["edits"][i] > K:
            continue
        checked += 1
        recs = sam.get(q, [])
        c, p, s = truth["ctg"][i], truth["pos"][i], truth["strand"][i]
        if origin_found(recs, names[c], p, s):
            found += 1
            continue
        if not strict and recs:
            fwd = alphabet.revcomp(reads[i]) if s else reads[i]
            win = seqs[c][max(0, p - SLACK):p + reads.shape[1] + SLACK]
            if min(r[3] for r in recs) < semiglobal_ed(fwd, win):
                better += 1
                continue
        missed.append(q)
    return dict(checked=checked, at_origin=found, better_elsewhere=better,
                missed=len(missed), missed_examples=missed[:5])


# --------------------------------------------------------------------------
# Brute-force oracles in jax.numpy (run on the card)
# --------------------------------------------------------------------------

def _bitplanes(text, pad_words: int):
    """2-bit codes (n,) -> low and high bit planes, 32 positions per uint32
    word (bit b of word w = position 32w + b), pad_words zero words
    appended."""
    n = text.shape[0]
    words = -(-n // 32) + pad_words
    t = jnp.pad(text.astype(jnp.uint32), (0, words * 32 - n))
    t = t.reshape(words, 32)
    sh = jnp.arange(32, dtype=jnp.uint32)
    lo = ((t & 1) << sh).sum(axis=1, dtype=jnp.uint32)
    hi = ((t >> 1) << sh).sum(axis=1, dtype=jnp.uint32)
    return lo, hi


@partial(jax.jit, static_argnames=("n", "k", "cap"))
def _hamming_words(lo, hi, pats, n: int, k: int, cap: int):
    """Bit-parallel Hamming scan of patterns (P, m) over all n - m + 1
    start positions. Returns (count, pat, word, ok bits, ge planes) of the
    words holding a start with <= k mismatches; ge[j] bit = mismatches
    >= j + 1."""
    P, m = pats.shape
    W = -(-n // 32)

    def body(i, ge):
        q = i // 32
        r = (i % 32).astype(jnp.uint32)

        def shifted(plane):
            a = jax.lax.dynamic_slice(plane, (q,), (W,))
            b = jax.lax.dynamic_slice(plane, (q + 1,), (W,))
            up = jnp.where(r == 0, jnp.uint32(0),
                           b << ((jnp.uint32(32) - r) % 32))
            return (a >> r) | up

        c = pats[:, i].astype(jnp.uint32)
        full = jnp.uint32(0xFFFFFFFF)
        clo = jnp.where((c & 1) == 1, full, jnp.uint32(0))[:, None]
        chi = jnp.where((c >> 1) == 1, full, jnp.uint32(0))[:, None]
        mis = (shifted(lo)[None] ^ clo) | (shifted(hi)[None] ^ chi)
        new = [ge[0] | mis] + [ge[j] | (ge[j - 1] & mis)
                               for j in range(1, k + 1)]
        return jnp.stack(new)

    ge = jax.lax.fori_loop(0, m, body,
                           jnp.zeros((k + 1, P, W), jnp.uint32))
    # valid starts: p <= n - m
    pos = (jnp.arange(W, dtype=jnp.int32)[:, None] * 32
           + jnp.arange(32, dtype=jnp.int32)[None, :])
    valid = ((pos <= n - m).astype(jnp.uint32)
             << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
                 axis=1, dtype=jnp.uint32)
    ok = ~ge[k] & valid[None, :]
    nz = ok != 0
    count = nz.sum()
    pi, wi = jnp.nonzero(nz, size=cap, fill_value=0)
    return count, pi, wi, ok[pi, wi], ge[:k, pi, wi]


def brute_hamming(text, pats: np.ndarray, k: int, chunk: int = 64,
                  cap: int = 1 << 16) -> set:
    """All (pattern, begin, distance <= k) of each pattern over the whole
    text (device array of 2-bit codes), by a bit-parallel scan."""
    n = int(text.shape[0])
    m = pats.shape[1]
    lo, hi = _bitplanes(text, m // 32 + 2)
    out = set()
    for c0 in range(0, len(pats), chunk):
        blk = jnp.asarray(pats[c0:c0 + chunk].astype(np.int32))
        count, pi, wi, okw, gew = (np.asarray(x) for x in _hamming_words(
            lo, hi, blk, n=n, k=k, cap=cap))
        if int(count) > cap:
            raise RuntimeError(f"hamming oracle cap {cap} < {int(count)}")
        for j in range(int(count)):
            w = int(okw[j])
            while w:
                b = (w & -w).bit_length() - 1
                w &= w - 1
                d = sum((int(gew[x, j]) >> b) & 1 for x in range(k))
                out.add((c0 + int(pi[j]), int(wi[j]) * 32 + b, d))
    return out


@partial(jax.jit, static_argnames=("k", "cap"))
def _edit_ends(text, pat, k: int, cap: int):
    """jnp port of the tests' brute_edit_ends: semi-global edit distance of
    pat ending at every text position (free start), local minima <= k."""
    n = text.shape[0]
    cols = jnp.arange(1, n + 1, dtype=jnp.int32)

    def row(j, prev):
        mis = (text != pat[j - 1]).astype(jnp.int32)
        best = jnp.minimum(prev[:-1] + mis, prev[1:] + 1)
        left = jax.lax.cummin(best - cols) + cols
        cur = jnp.minimum(jnp.minimum(best, left), j)
        return jnp.concatenate([j[None].astype(jnp.int32), cur])

    final = jax.lax.fori_loop(1, pat.shape[0] + 1, row,
                              jnp.zeros(n + 1, jnp.int32))[1:]
    big = jnp.full((1,), 127, jnp.int32)
    left = jnp.concatenate([big, final[:-1]])
    right = jnp.concatenate([final[1:], big])
    keep = (final <= k) & (final < left) & (final <= right)
    (idx,) = jnp.nonzero(keep, size=cap, fill_value=0)
    return keep.sum(), idx + 1, final[idx]


def brute_edit_ends(text, pat: np.ndarray, k: int, cap: int = 4096) -> set:
    """(end, distance) local minima <= k of pat over the whole text."""
    count, ends, dist = (np.asarray(x) for x in _edit_ends(
        text, jnp.asarray(pat.astype(np.int32)), k=k, cap=cap))
    if int(count) > cap:
        raise RuntimeError(f"edit oracle cap {cap} < {int(count)}")
    c = int(count)
    return set(zip(ends[:c].tolist(), dist[:c].tolist()))


def covered(brute: set, got: set, k: int) -> set:
    """Brute-force (read, strand, end, d) not covered by a reported
    occurrence of the same read and strand with distance <= d and end
    within the reporting filter's window (2k - 1, reference
    src/indexinterface.cpp:1451-1485)."""
    by = {}
    for r, s, e, d in got:
        by.setdefault((r, s), []).append((e, d))
    w = max(1, 2 * k) - 1
    return {(r, s, e, d) for r, s, e, d in brute
            if not any(abs(e2 - e) <= w and d2 <= d
                       for e2, d2 in by.get((r, s), ()))}


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

class Smoke:
    """State shared by the phases of one run. The sizes are the deployment's;
    a rehearsal on the CPU shrinks them on the instance."""

    hap_bp = HAP_BP
    n_se = 50_000           # single-end 100 bp reads, ALL k=2
    n_best = 20_000         # single-end 150 bp reads, BEST
    n_pairs = 10_000        # 2 x 100 bp pairs
    n_rlc = 10_000          # first SE reads aligned again on the RLC index
    n_ham, n_edit = 256, 64  # oracle reads, Hamming and edit
    mesh_reads = 4 * 8192   # four 8,192-read shards

    def __init__(self, seed: int):
        self.seed = seed
        self.dir = os.path.join(HERE, ".smoke", f"seed{seed}")
        self.fasta = os.path.join(self.dir, "genome.fa")
        self.idx = os.path.join(self.dir, "vanilla.cidx")
        self.rlc_idx = os.path.join(self.dir, "rlc.cidx")
        self.names = self.seqs = None
        self.index = self.arrays = None
        self.se = None

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def genome(self):
        if self.seqs is None:
            self.names, self.seqs = make_genome(self.seed, self.hap_bp)
        return self.names, self.seqs

    def se_reads(self):
        if self.se is None:
            _, seqs = self.genome()
            self.se = sample_reads(self.seed + 1, seqs, self.n_se, 100)
        return self.se

    def cli(self, argv, log: str) -> None:
        """cli.main in this process, its stderr kept in a log file."""
        from columba_jax import cli

        with open(self.path(log), "w") as f, \
                contextlib.redirect_stderr(f):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli {argv[0]} exited {rc}; see {log}")

    def device_index(self):
        if self.index is None:
            from columba_jax.index.build import load_index
            from columba_jax.index.fmindex import FMIndex

            self.arrays = load_index(self.idx)
            self.index = FMIndex.from_arrays(self.arrays)
        return self.index


def phase_device(sm: Smoke, cards: int) -> dict:
    from columba_jax import device

    device.require_gpu()
    devs = jax.devices()
    if len(devs) < cards:
        raise SystemExit(f"need {cards} GPUs, JAX sees {len(devs)}")
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), backend=jax.default_backend())


def phase_native(sm: Smoke) -> dict:
    from columba_jax import native

    libs = {"parse": ["parse.cpp"], "emit": ["emit.cpp"],
            "sais": ["sais.cpp"]}
    missing = [n for n, src in libs.items() if native.load(n, src) is None]
    if missing:
        raise RuntimeError(f"native libraries failed to load: {missing}")
    return dict(loaded=sorted(libs))


def phase_build(sm: Smoke) -> dict:
    names, seqs = sm.genome()
    os.makedirs(sm.dir, exist_ok=True)
    built = not os.path.exists(os.path.join(sm.idx, "meta.json"))
    t0 = time.perf_counter()
    if built:
        write_fasta(sm.fasta, names, seqs)
        sm.cli(["build", "-r", sm.idx, "-f", sm.fasta], "build.log")
    build_s = time.perf_counter() - t0
    index = sm.device_index()
    nbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(index))
    return dict(genome_bp=sum(len(s) for s in seqs), contigs=len(names),
                n_bases=int(sum((s == 4).sum() for s in seqs)),
                built=built, build_s=round(build_s, 1),
                index_device_bytes=nbytes)


def _align(sm: Smoke, argv, log: str, n: int) -> float:
    t0 = time.perf_counter()
    sm.cli(["align", "-r", sm.idx] + argv, log)
    return n / (time.perf_counter() - t0)


def _recall_ok(res: dict) -> bool:
    return res["checked"] > 0 and res["missed"] == 0


def phase_align_se_all(sm: Smoke) -> dict:
    names, seqs = sm.genome()
    reads, truth = sm.se_reads()
    fq, out = sm.path("se100.fq"), sm.path("se_all.sam")
    write_fastq(fq, reads)
    rate = _align(sm, ["-f", fq, "-o", out, "-a", "all", "-e", str(K),
                       "-S", "kuch1", "-b", "16384"], "align_se_all.log",
                  len(reads))
    sam = parse_sam(out)
    res = check_recall(sam, names, seqs, reads, truth,
                       [f"r{i}" for i in range(len(reads))], strict=True)
    res.update(reads=len(reads), mapped=len(sam),
               reads_per_s_incl_compile=round(rate, 1))
    res["ok"] = _recall_ok(res)
    return res


def phase_align_se_best(sm: Smoke) -> dict:
    names, seqs = sm.genome()
    reads, truth = sample_reads(sm.seed + 2, seqs, sm.n_best, 150)
    fq, out = sm.path("se150.fq"), sm.path("se_best.sam")
    write_fastq(fq, reads)
    rate = _align(sm, ["-f", fq, "-o", out, "-S", "columba"],
                  "align_se_best.log", len(reads))
    sam = parse_sam(out)
    res = check_recall(sam, names, seqs, reads, truth,
                       [f"r{i}" for i in range(len(reads))], strict=False)
    res.update(reads=len(reads), mapped=len(sam),
               reads_per_s_incl_compile=round(rate, 1))
    res["ok"] = _recall_ok(res)
    return res


def phase_align_pe(sm: Smoke) -> dict:
    from columba_jax.core import alphabet

    names, seqs = sm.genome()
    r1, r2, t = sample_pairs(sm.seed + 3, seqs, sm.n_pairs, 100)
    f1, f2, out = sm.path("pe_1.fq"), sm.path("pe_2.fq"), sm.path("pe.sam")
    write_fastq(f1, r1, "p")
    write_fastq(f2, r2, "p")
    rate = _align(sm, ["-f", f1, "-F", f2, "-o", out], "align_pe.log",
                  len(r1))
    sam = parse_sam(out)
    checked = found = better = 0
    missed = []
    for i in range(len(r1)):
        if t["edits1"][i] > K or t["edits2"][i] > K:
            continue
        checked += 1
        recs = sam.get(f"p{i}", [])
        rn = names[t["ctg"][i]]
        if (origin_found(recs, rn, t["pos1"][i], t["strand1"][i], 0x40)
                and origin_found(recs, rn, t["pos2"][i], t["strand2"][i],
                                 0x80)):
            found += 1
            continue
        # a pair may legitimately map only elsewhere when that placement
        # is strictly better than the origin's true total distance
        true = 0
        for r, p, s in ((r1[i], t["pos1"][i], t["strand1"][i]),
                        (r2[i], t["pos2"][i], t["strand2"][i])):
            fwd = alphabet.revcomp(r) if s else r
            win = seqs[t["ctg"][i]][max(0, p - SLACK):p + 100 + SLACK]
            true += semiglobal_ed(fwd, win)
        nm1 = [x[3] for x in recs if x[0] & 0x40]
        nm2 = [x[3] for x in recs if x[0] & 0x80]
        if nm1 and nm2 and min(nm1) + min(nm2) < true:
            better += 1
            continue
        missed.append(f"p{i}")
    res = dict(pairs=len(r1), checked=checked, at_origin=found,
               better_elsewhere=better, missed=len(missed),
               missed_examples=missed[:5],
               pairs_per_s_incl_compile=round(rate, 1))
    res["ok"] = checked > 0 and not missed
    return res


def _occ_set(sam: dict, qnames) -> set:
    return {(q, bool(f & 16), rn, p, nm) for q in qnames
            for f, rn, p, nm in sam.get(q, [])}


def phase_align_rlc(sm: Smoke) -> dict:
    reads, _ = sm.se_reads()
    n = min(sm.n_rlc, len(reads))
    fq = sm.path("se100_rlc.fq")
    write_fastq(fq, reads[:n])
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(sm.rlc_idx, "meta.json")):
        if not os.path.exists(sm.fasta):
            write_fasta(sm.fasta, *sm.genome())
        sm.cli(["build", "-r", sm.rlc_idx, "-f", sm.fasta, "--rlc"],
               "build_rlc.log")
    build_s = time.perf_counter() - t0
    out = sm.path("se_rlc.sam")
    t0 = time.perf_counter()
    sm.cli(["align", "-r", sm.rlc_idx, "-f", fq, "-o", out, "-a", "all",
            "-e", str(K), "-S", "kuch1", "-b", "16384"], "align_rlc.log")
    align_s = time.perf_counter() - t0
    qn = [f"r{i}" for i in range(n)]
    rlc = _occ_set(parse_sam(out), qn)
    van = _occ_set(parse_sam(sm.path("se_all.sam")), qn)
    return dict(reads=n, build_s=round(build_s, 1), align_s=round(align_s, 1),
                occurrences=len(rlc), only_rlc=len(rlc - van),
                only_vanilla=len(van - rlc), ok=bool(rlc) and rlc == van)


def phase_oracle(sm: Smoke) -> dict:
    from columba_jax.core import alphabet
    from columba_jax.index.build import decoded_text
    from columba_jax.search import strategy

    index = sm.device_index()
    text = jnp.asarray(decoded_text(sm.arrays))
    reads, _ = sm.se_reads()
    res = {}

    # Hamming k=2: exact set equality over the whole genome, both strands
    ham = reads[:sm.n_ham]
    t0 = time.perf_counter()
    cfg = strategy.MappingConfig(mode="all", metric="hamming",
                                 max_distance=K, scheme_name="kuch1")
    got = {(o.read_id, o.strand, o.begin, o.distance)
           for mr in strategy.map_batch_all(index, ham, cfg)
           for o in mr.occs}
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pats = np.concatenate([ham, alphabet.revcomp(ham, axis=-1)])
    R = len(ham)
    expect = {(p % R, p // R, b, d)
              for p, b, d in brute_hamming(text, pats, K)}
    res.update(ham_reads=R, ham_occ=len(expect), ham_lib_s=round(lib_s, 1),
               ham_brute_s=round(time.perf_counter() - t0, 1),
               ham_missing=len(expect - got), ham_spurious=len(got - expect))
    ham_ok = expect == got

    # edit k=2: lossless + sound against the DP over the whole genome
    ed = reads[sm.n_ham:sm.n_ham + sm.n_edit]
    t0 = time.perf_counter()
    cfg = strategy.MappingConfig(mode="all", metric="edit", max_distance=K,
                                 scheme_name="kuch1")
    got = {(o.read_id, o.strand, o.end, o.distance)
           for mr in strategy.map_batch_all(index, ed, cfg)
           for o in mr.occs}
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    brute = set()
    for i, r in enumerate(ed):
        for s, rr in ((0, r), (1, alphabet.revcomp(r))):
            brute |= {(i, s, e, d) for e, d in brute_edit_ends(text, rr, K)}
    lost = covered(brute, got, K)
    unsound = got - brute
    res.update(edit_reads=len(ed), edit_brute_occ=len(brute),
               edit_reported=len(got), edit_lib_s=round(lib_s, 1),
               edit_brute_s=round(time.perf_counter() - t0, 1),
               edit_lost=len(lost), edit_unsound=len(unsound))
    res["ok"] = ham_ok and not lost and not unsound and bool(expect)
    return res


def phase_mesh4(sm: Smoke) -> dict:
    """dist/mesh.sharded_match on a 4-card data mesh vs one card."""
    from columba_jax.dist import mesh as dmesh
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    index = sm.device_index()
    reads, _ = sm.se_reads()
    batch = np.asarray(reads[:sm.mesh_reads], np.int32)
    sched = pipeline.compile_cached(get_scheme("kuch1", K), 100, "edit")
    cap, ml = 3 * 8192, 4 * 8192         # per shard
    mesh = dmesh.make_data_mesh(4)
    t0 = time.perf_counter()
    out4 = dmesh.sharded_match(mesh, index, jnp.asarray(batch), sched,
                               capacity_per_shard=cap,
                               max_locate_per_shard=ml, kb=K)
    jax.block_until_ready(out4)
    mesh_s = time.perf_counter() - t0
    placement = [(s.device.id, s.device.platform, int(s.data.shape[0]),
                  int(np.asarray(s.data).astype(bool).sum()))
                 for s in out4["valid"].addressable_shards]

    one = jax.jit(partial(pipeline.match_device_core, sched=sched,
                          capacity=4 * cap, max_locate=4 * ml, kb=K))
    t0 = time.perf_counter()
    out1 = one(index, jnp.asarray(batch),
               tables=pipeline.device_tables(sched))
    jax.block_until_ready(out1)
    one_s = time.perf_counter() - t0

    def rows(o):
        o = {k: np.asarray(v) for k, v in o.items()}
        v = o["valid"]
        return {(int(r), int(w), f.tobytes()) for r, w, f in zip(
            o["rid"][v], o["win_start"][v], o["final_rows"][v])}

    r4, r1 = rows(out4), rows(out1)
    sc = {k: (int(out4[k]), int(out1[k]))
          for k in ("total", "n_unique", "overflow")}
    return dict(reads=len(batch), mesh_s=round(mesh_s, 1),
                one_card_s=round(one_s, 1), live_rows=len(r4),
                rows_equal=r4 == r1, scalars=sc,
                placement=placement,
                ok=(r4 == r1 and len(r4) > 0
                    and all(a == b for a, b in sc.values())
                    and sc["overflow"][0] == 0
                    and len({p[0] for p in placement}) == 4))


# --------------------------------------------------------------------------

def _run(name: str, fn, *args) -> dict | None:
    t0 = time.perf_counter()
    try:
        res = fn(*args)
    except Exception:           # a phase that raises fails the run
        print(f"[smoke] phase={name} ok=False seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)
        traceback.print_exc()
        return None
    ok = res.pop("ok", True)
    print(f"[smoke] phase={name} ok={ok} seconds="
          f"{time.perf_counter() - t0:.1f} {json.dumps(res)}", flush=True)
    return res if ok else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=19)
    args = ap.parse_args(argv)

    sm = Smoke(args.seed)
    dev = _run("device", phase_device, sm, args.cards)
    if dev is None:
        return 1
    from columba_jax import device

    if args.cards == 4:
        phases = [("build", phase_build), ("mesh4", phase_mesh4)]
    else:
        phases = [("native", phase_native), ("build", phase_build),
                  ("align_se_all", phase_align_se_all),
                  ("align_se_best", phase_align_se_best),
                  ("align_pe", phase_align_pe),
                  ("align_rlc", phase_align_rlc),
                  ("oracle", phase_oracle)]
    failed = []
    for name, fn in phases:
        if _run(name, fn, sm) is None:
            failed.append(name)
            if name in ("native", "build"):
                break
    peak = [d.memory_stats().get("peak_bytes_in_use") for d in
            jax.devices()[:args.cards]]
    print(f"[smoke] peak device bytes in use: {peak}", flush=True)
    print(f"[smoke] cards: {device.describe()}", flush=True)
    if failed:
        print(f"[smoke] FAILED phases: {failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
