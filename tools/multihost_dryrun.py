"""Two-process multi-host dryrun: jax.distributed + gloo on CPU meshes.

Validates the full multi-host story (columba_jax/dist/multihost.py) with
two local processes, 4 virtual devices each (8-device global data mesh):

  1. both processes initialize jax.distributed against a local coordinator,
  2. both build the SAME small index from the same seed (as two hosts
     loading one persisted index would),
  3. each "host" reads ITS OWN half of the read set (per-host file
     sharding), shards it onto its addressable devices,
  4. the sharded match step runs over the global mesh; counters psum,
  5. each host extracts occurrences from its addressable output shards and
     checks recall against its known sampled positions,
  6. host 0 gathers the per-host summaries (via the coordinator KV store)
     and prints ONE JSON line {"ok": true, ...}.

Run:  python tools/multihost_dryrun.py            (orchestrates 2 procs)
      python tools/multihost_dryrun.py --proc I   (one worker, internal)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
COORD = "127.0.0.1:49733"
NPROC = 2
DEV_PER_PROC = 4
READS_PER_HOST = 64
M = 80
K = 2


def worker(proc_id: int) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    # initialize the distributed runtime BEFORE importing anything that
    # touches the XLA backend (some modules build jnp constants at import)
    from columba_jax.dist import multihost

    multihost.initialize(COORD, NPROC, proc_id, cpu_gloo=True)

    from columba_jax.core import alphabet
    from columba_jax.dist import mesh as dmesh
    from columba_jax.index.build import build_index_from_codes
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    mesh = multihost.global_mesh()
    assert len(jax.devices()) == NPROC * DEV_PER_PROC

    # every host builds the same index (== loading one persisted index)
    rng = np.random.default_rng(777)
    genome = rng.integers(0, 4, size=200_000).astype(np.uint8)
    arrays = build_index_from_codes(genome)
    index = FMIndex.from_arrays(arrays)

    # per-host input shard: host i samples ITS OWN reads (disjoint seeds)
    hrng = np.random.default_rng(1000 + proc_id)
    starts = hrng.integers(0, len(genome) - M - 4, size=READS_PER_HOST)
    local_fwd = np.stack([genome[s:s + M] for s in starts]).astype(np.int32)
    # feed fwd + rc like match_all does
    local_rows = np.concatenate(
        [local_fwd, np.asarray(alphabet.revcomp(local_fwd, axis=-1))])

    sched = pipeline.compile_cached(get_scheme("kuch1", K), M, "edit")
    reads_g = multihost.shard_batch(mesh, local_rows)
    out = dmesh.sharded_match(
        mesh, index, reads_g, sched,
        capacity_per_shard=2048, max_locate_per_shard=2048, kb=K,
        globalize=lambda t: multihost.replicate(mesh, t),
    )
    res = multihost.local_out(out)

    # recall: every sampled start must be recovered by this host's shards.
    # Shard layout is process-ordered, so this host's lanes cover rows
    # [proc_id * 2R_local, (proc_id+1) * 2R_local) of the global batch.
    ends = pipeline.signed_positions(res["win_start"]) + M  # per final row
    got = set()
    base = proc_id * local_rows.shape[0]
    for rid, valid, rows_v, e in zip(res["rid"], res["valid"],
                                     res["final_rows"], ends):
        if not valid or rows_v.min() > K:
            continue
        lid = int(rid) - base
        if 0 <= lid < READS_PER_HOST:  # fwd lanes of this host
            got.add((lid, int(e)))
    recall = sum(
        1 for i, s in enumerate(starts) if (i, int(s) + M + K) in got
        or (i, int(s) + M) in got or any((i, int(s) + M + d) in got
                                         for d in range(-K, K + 1))
    ) / READS_PER_HOST

    summary = dict(proc=proc_id, recall=recall,
                   total=res["total"], overflow=res["overflow"],
                   nodes=res["nodes_visited"])
    # host 0 gathers via the coordinator's KV store
    client = jax._src.distributed.global_state.client
    client.key_value_set(f"dryrun/{proc_id}", json.dumps(summary))
    client.wait_at_barrier("dryrun_done", 60_000)
    if proc_id == 0:
        all_s = [json.loads(client.blocking_key_value_get(
            f"dryrun/{p}", 10_000)) for p in range(NPROC)]
        ok = all(s["recall"] == 1.0 for s in all_s)
        # counters are psum'd: every host must report the same global total
        ok &= len({s["total"] for s in all_s}) == 1
        ok &= all(s["overflow"] == 0 for s in all_s)
        print(json.dumps(dict(
            ok=bool(ok), hosts=NPROC, devices=NPROC * DEV_PER_PROC,
            recalls=[s["recall"] for s in all_s],
            global_candidates=all_s[0]["total"])))
        return 0 if ok else 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None)
    args = ap.parse_args()
    if args.proc is not None:
        return worker(args.proc)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--proc", str(i)],
                         stdout=(None if i == 0 else subprocess.DEVNULL),
                         stderr=subprocess.DEVNULL)
        for i in range(NPROC)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
