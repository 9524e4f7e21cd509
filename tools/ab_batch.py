"""A/B: headline bench batch size sweep.

PERF.md's gather microbenchmark shows the issue-bound gather rate rising
~40% from 32k to 512k lanes; the headline bench runs 8192-read batches
(= 49k exact-prefix lanes). This sweeps BATCH through the bench's own
measurement path to find the per-chip sweet spot.

Usage: python tools/ab_batch.py [BATCH ...]   (default 8192 16384 32768)
"""

from __future__ import annotations

import sys

sys.path.insert(0, __import__("os").path.join(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__)), ".."))

import bench  # noqa: E402


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [8192, 16384, 32768, 65536]
    genome, reads = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    # trim the read set to a common multiple of all swept batch sizes so
    # every sweep point measures the SAME workload (len//B*B would otherwise
    # give each size a slightly different read count)
    biggest = max(sizes)
    common = (len(reads) // biggest) * biggest
    if any(common % b for b in sizes):
        raise SystemExit("batch sizes must divide the largest size "
                         f"({biggest}) for an apples-to-apples sweep")
    reads = reads[:common]
    print(f"sweep over {common} reads per point", flush=True)
    results = {}
    for b in sizes:
        bench.BATCH = b
        rate = bench.measure_device(arrays, reads)
        results[b] = rate
        print(f"BATCH={b:6d}  {rate / 1e3:8.1f}k reads/s", flush=True)
    best = max(results, key=results.get)
    print(f"best: BATCH={best} at {results[best] / 1e3:.1f}k reads/s")


if __name__ == "__main__":
    main()
