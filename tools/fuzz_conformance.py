import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np, sys
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
from tests.test_pipeline import brute_edit_ends, brute_hamming
from tests.conftest import make_genome
from columba_jax.core import alphabet
from columba_jax.index.build import build_index_from_codes
from columba_jax.index.fmindex import FMIndex
from columba_jax.index.kmer import build_kmer_table
from columba_jax.search import pipeline
from columba_jax.search.scheme import get_scheme

fails = 0
trials = 0
for seed in range(40):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(5000, 40000))
    g = make_genome(rng, n)
    index = FMIndex.from_arrays(build_index_from_codes(g))
    kt = build_kmer_table(index, 6)
    for trial in range(2):
        name = ["kuch1", "kuch2", "kianfar", "pigeon", "01*0"][int(rng.integers(0, 5))]
        k = int(rng.integers(1, 4))
        metric = ["edit", "hamming"][int(rng.integers(0, 2))]
        m = int(rng.integers(40, 110))
        sw = int(rng.choice([0, 4]))
        part = ["uniform", "dynamic", "static"][int(rng.integers(0, 3))]
        use_kt = bool(rng.integers(0, 2))
        B = 6
        reads = np.zeros((B, m), np.uint8)
        for i in range(B):
            # always include text-edge reads (regression: occurrences at
            # the genome start were once lost in verify)
            if i == 0:
                s = int(rng.integers(0, 3))
            elif i == 1:
                s = n - m - 1
            else:
                s = int(rng.integers(0, n - m - 4))
            r = g[s:s+m].astype(np.int64).copy()
            ne = int(rng.integers(0, k + 1))
            for _ in range(ne):
                j = int(rng.integers(0, len(r)))
                op = rng.random()
                if metric == "hamming" or op < 0.5:
                    r[j] = (r[j] + 1 + int(rng.integers(0, 3))) % 4
                elif op < 0.75 and len(r) > 1:
                    r = np.delete(r, j)
                else:
                    r = np.insert(r, j, int(rng.integers(0, 4)))
            r = r[:m]
            if len(r) < m:
                r = np.concatenate([r, g[s+len(r):s+m]])
            reads[i] = r.astype(np.uint8)
        try:
            occs, stats = pipeline.match_all(
                index, reads, get_scheme(name, k), metric=metric,
                redundancy_filter=False, switchpoint=sw,
                partitioning=part, kmer_table=kt if use_kt else None)
        except Exception as e:
            print(f"CRASH seed={seed} {name} k={k} {metric} m={m} sw={sw} {part}: {e}")
            fails += 1
            continue
        trials += 1
        if stats["overflow"]:
            continue
        got = {(o.read_id, o.strand, (o.end if metric=='edit' else o.begin), o.distance) for o in occs}
        expect = set()
        for i, r in enumerate(reads):
            for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
                if metric == "edit":
                    for e, d in brute_edit_ends(g, rr, k):
                        expect.add((i, strand, e, d))
                else:
                    for p, d in brute_hamming(g, rr, k):
                        expect.add((i, strand, p, d))
        if got != expect:
            fails += 1
            print(f"MISMATCH seed={seed} {name} k={k} {metric} m={m} sw={sw} "
                  f"{part} kt={use_kt}: missing={len(expect-got)} spurious={len(got-expect)}")
            for x in sorted(expect - got)[:3]:
                print("   missing", x)
print(f"fuzz done: {trials} trials, {fails} failures")
