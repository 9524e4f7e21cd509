"""RLC (b-move) backend throughput at bench scale on the GPU.

Same workload/config as bench.py but on the run-length-compressed index
(no in-text crossover: the RLC index stores no text, matching the
reference b-move's getSwitchPoint()==0). Prints one JSON line.

--pan: instead of the random 128 Mbp genome, a synthetic PAN-GENOME of 20
near-identical haplotypes (0.1% divergence) of a 6.4 Mbp base — the
repetitive r << n regime RLC exists for, where BWT runs are huge and a
locate that walks to a RUN-BOUNDARY sample would cost (run length)/2 LF
steps per occurrence (the round-1 weakness). The strided in-run SA samples
(index/bmove.py LOCATE_STRIDE) bound the walk at <= stride regardless of
run length; comparing this mode's reads/s against the default random
genome (maximally short runs) is the measurement that locate cost is
independent of run length. Reference contrast: toehold + phi-walk bounded
by PLCP (src/bmove/bmove.cpp:503-547, src/bmove/plcp.h:59-130) — a
sequential pointer chase per occurrence list that batches poorly on a lockstep device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

CACHE = "/tmp/columba_jax_bench/bmove.cidx"
PAN_CACHE = "/tmp/columba_jax_bench/bmove_pan.cidx"
HAPLOTYPES = 20
DIVERGENCE = 0.001


def pan_workload():
    """20 haplotypes x 6.4 Mbp, 0.1% SNP divergence + reads off them."""
    base_n = bench.GENOME_N // HAPLOTYPES
    rng = np.random.default_rng(20260820)
    base = rng.integers(0, 4, size=base_n).astype(np.uint8)
    haps = [base]
    for _ in range(HAPLOTYPES - 1):
        h = base.copy()
        snps = rng.random(base_n) < DIVERGENCE
        h[snps] = (h[snps] + rng.integers(1, 4, snps.sum())) % 4
        haps.append(h)
    genome = np.concatenate(haps)
    nreads = bench.NUM_READS
    starts = rng.integers(0, len(genome) - bench.READ_LEN - 8, size=nreads)
    reads = np.zeros((nreads, bench.READ_LEN), dtype=np.uint8)
    from columba_jax.core import alphabet

    for i, s in enumerate(starts):
        seq = genome[s:s + bench.READ_LEN].copy()
        for _ in range(int(rng.poisson(bench.ERR_RATE * bench.READ_LEN))):
            j = int(rng.integers(0, bench.READ_LEN))
            seq[j] = (seq[j] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.5:
            seq = alphabet.revcomp(seq)
        reads[i] = seq
    return genome, reads


def main():
    import jax
    import jax.numpy as jnp

    from columba_jax.index.bmove import (
        BMoveIndex, build_bmove_from_codes, load_bmove, save_bmove)
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    pan = "--pan" in sys.argv
    cache = PAN_CACHE if pan else CACHE
    genome, reads = pan_workload() if pan else bench.build_workload()
    if os.path.exists(os.path.join(cache, "meta.json")):
        arrays = load_bmove(cache)
    else:
        t0 = time.time()
        arrays = build_bmove_from_codes(genome)
        print(f"[rlc] build {time.time()-t0:.0f}s", file=sys.stderr)
        save_bmove(arrays, cache)
    index = BMoveIndex.from_arrays(arrays)
    n, r = index.n, index.r_fwd
    print(f"[rlc] n={n} r={r} n/r={n/max(r,1):.1f} "
          f"(mean run length)", file=sys.stderr)

    B = bench.BATCH
    m = bench.READ_LEN
    sched = pipeline.compile_cached(get_scheme("kuch1", bench.K), m, "edit")
    tables = pipeline.device_tables(sched)
    capacity = 6 * B
    max_locate = 1 << 15
    max_verify = 12288

    def _step(idx, rows, tbl):
        # no crossover (no text), but errorful lanes still die in the band
        # phase: shrink the frontier after 2 band steps
        return pipeline.match_device_core(
            idx, rows, sched, tbl, capacity, max_locate, bench.K,
            split_step=2, capacity2=2 * B, max_verify=max_verify)

    step = jax.jit(_step)
    nbatch = len(reads) // B

    def rows_of(i):
        b = reads[i * B:(i + 1) * B].astype(np.int32)
        return jnp.asarray(np.concatenate([b, 3 - b[:, ::-1]]))

    dev_rows = [rows_of(i) for i in range(nbatch)]
    t0 = time.time()
    out = step(index, dev_rows[0], tables)
    int(out["total"])
    print(f"[rlc] warmup+compile {time.time()-t0:.1f}s", file=sys.stderr)

    def run_epochs(epochs):
        t0 = time.time()
        tot = jnp.zeros((), jnp.int32)
        for _ in range(epochs):
            for i in range(nbatch):
                o = step(index, dev_rows[i], tables)
                tot = tot + o["total"] + o["n_unique"]
        chk = int(tot)
        return time.time() - t0, chk

    dt1, chk = run_epochs(1)
    epochs = max(1, int(2.0 / max(dt1, 1e-3)) + 1)
    print(f"[rlc] probe {dt1*1e3:.0f}ms chk={chk} -> {epochs} epochs",
          file=sys.stderr)
    dt, _ = run_epochs(epochs)
    rps = epochs * nbatch * B / dt
    name = ("rlc_pan20x0.1pct" if pan else "rlc_random")
    print(json.dumps({
        "metric": f"{name}_reads_per_sec_per_chip_100bp_k2_edit_kuch1_all",
        "value": round(rps, 1), "unit": "reads/s",
        "n": int(n), "r": int(r),
        "mean_run_len": round(n / max(r, 1), 1)}))


if __name__ == "__main__":
    main()
