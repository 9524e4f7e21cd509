"""RLC memory story, end to end: index bytes + reads/s per flavor on the
pan-genome workload (VERDICT r3 item 4).

Builds THREE indexes over the same repeat-rich pan genome (20 haplotypes x
0.1% divergence, 128 Mbp — the r << n regime b-move exists for) and runs
the same 100k-read SE k=2 align through the full CLI on each:

  vanilla    dense-SA FM index (-s 1), CIGARs on      (bench.py headline cfg)
  rlc        run-length move tables + packed text + strided SA samples
  textless   rlc --textless: NO text, NO SA samples — index bytes scale
             with the run count r, not n (reference: src/bmove/bmove.cpp
             textless stubs :594-657, PLCP-based locate src/bmove/plcp.h)

Reference contrast: the reference RLC default likewise emits no CIGARs
(b-move positions only); rlc/textless rows here run the CLI default
(no -aC), vanilla runs its default (CIGARs on) — each flavor at the
settings its users get.

Run: python tools/bench_rlc_e2e.py [--reads 100000] [--flavors v,r,t]
Prints one markdown table + one JSON line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import sys
import time
from contextlib import redirect_stderr

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

CACHE = "/tmp/columba_jax_bench"


def du(path: str) -> int:
    tot = 0
    for root, _, files in os.walk(path):
        for f in files:
            tot += os.path.getsize(os.path.join(root, f))
    return tot


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--flavors", default="v,r,t")
    args = ap.parse_args()

    from bench_matrix import ensure_workload

    from columba_jax import cli, compile_cache
    from columba_jax.core import alphabet

    compile_cache.enable()
    fq, _, _ = ensure_workload(args.reads, pan=True)

    import numpy as np

    from bench_matrix import pan_genome

    genome = pan_genome()
    n = len(genome)
    fa = os.path.join(CACHE, "pan.fa")
    if not os.path.exists(fa):
        seq = alphabet.decode(np.asarray(genome))
        with open(fa, "w") as f:
            f.write(">pan\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")

    flavors = {
        "v": ("vanilla_s1", os.path.join(CACHE, "idx_pan_s1.cidx"),
              ["-s", "1"]),
        "r": ("rlc", os.path.join(CACHE, "pan_rlc.cidx"), ["--rlc"]),
        "t": ("rlc_textless", os.path.join(CACHE, "pan_rlc_tl.cidx"),
              ["--rlc", "--textless"]),
    }
    rows = []
    for key in args.flavors.split(","):
        name, idx, extra = flavors[key]
        if not os.path.exists(os.path.join(idx, "meta.json")):
            print(f"[rlc_e2e] building {name} ...", file=sys.stderr)
            t0 = time.time()
            rc = cli.main(["build", "-r", idx, "-f", fa] + extra)
            assert rc == 0
            print(f"[rlc_e2e] built {name} in {time.time()-t0:.0f}s",
                  file=sys.stderr)
        bytes_ = du(idx)
        out = os.path.join(CACHE, f"rlc_e2e_{name}.sam")
        cmd = ["align", "-r", idx, "-f", fq, "-o", out, "-a", "all",
               "-m", "edit", "-S", "kuch1", "-e", "2",
               "-b", str(args.batch), "-v", "-nD"]

        def once():
            buf = io.StringIO()
            t0 = time.time()
            with redirect_stderr(buf):
                rc = cli.main(list(cmd))
            assert rc == 0
            return time.time() - t0, buf.getvalue()

        print(f"[rlc_e2e] aligning on {name} ...", file=sys.stderr)
        once()
        dt, log = once()
        mapped = re.findall(r"Percentage reads mapped: ([\d.]+)%", log)
        rows.append(dict(
            flavor=name, index_bytes=bytes_,
            bytes_per_base=round(bytes_ / n, 3),
            rps=round(args.reads / dt, 1),
            pct_mapped=mapped[-1] if mapped else None))
        print(json.dumps(rows[-1]), file=sys.stderr)

    print("| flavor | index bytes | bytes/base | reads/s | % mapped |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['flavor']} | {r['index_bytes']:,} | "
              f"{r['bytes_per_base']} | {r['rps']:,} | {r['pct_mapped']}% |")
    print(json.dumps({"n": n, "rows": rows}))


if __name__ == "__main__":
    main()
