"""Multi-chip data parallelism: sharded match equals single-device match."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from columba_jax.core import alphabet
from columba_jax.index.fmindex import FMIndex
from columba_jax.search import pipeline
from columba_jax.search.scheme import get_scheme

from tests.conftest import sample_reads


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_match_equals_single(small_index, rng):
    from columba_jax.dist import mesh as dmesh

    genome, arrays = small_index
    index = FMIndex.from_arrays(arrays)
    m, k = 60, 2
    reads = sample_reads(rng, genome, num=16, length=m, max_err=k)
    rc = alphabet.revcomp(reads, axis=-1)
    batch = jnp.asarray(np.concatenate([reads, rc]).astype(np.int32))

    scheme = get_scheme("kuch1", k)
    sched = pipeline.compile_cached(scheme, m, "edit")
    mesh = dmesh.make_data_mesh(8)
    out_sh = dmesh.sharded_match(
        mesh, index, batch, sched,
        capacity_per_shard=1024, max_locate_per_shard=512, kb=k,
    )
    out_sh = {kk: np.asarray(v) for kk, v in out_sh.items()}

    out_1 = pipeline.match_device_core(
        index, batch, sched, pipeline.device_tables(sched),
        8 * 1024, 8 * 512, k,
    )
    out_1 = {kk: np.asarray(v) for kk, v in out_1.items()}

    assert int(out_sh["overflow"]) == 0
    assert int(out_sh["total"]) == int(out_1["total"])

    def occ_set(out):
        v = out["valid"]
        return set(zip(out["rid"][v].tolist(), out["win_start"][v].tolist()))

    assert occ_set(out_sh) == occ_set(out_1)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_match_seeded_crossover(small_index):
    """The multi-chip path with k-mer seeding + in-text crossover must match
    the single-chip path's occurrence set."""
    import jax.numpy as jnp
    import numpy as np

    from columba_jax.dist import mesh as dmesh
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, arrays = small_index
    index = FMIndex.from_arrays(arrays)
    kt = build_kmer_table(index, 6)
    rng = np.random.default_rng(9)
    m = 80
    starts = rng.integers(0, len(genome) - m, size=16)
    reads = np.stack([genome[s:s + m] for s in starts]).astype(np.int32)
    for i in range(16):
        j = int(rng.integers(0, m))
        reads[i, j] = (reads[i, j] + 1) % 4
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), m, "edit",
                                    kmer_k=table_k(kt))
    tables = pipeline.device_tables(sched)

    mesh8 = dmesh.make_data_mesh(8)
    single = pipeline.match_device_core(
        index, jnp.asarray(reads), sched, tables, 1024, 1024, 2,
        kmer_table=kt, switchpoint=4, itv_cap=1024, split_step=2,
        capacity2=256)
    multi = dmesh.sharded_match(
        mesh8, index, jnp.asarray(reads), sched,
        capacity_per_shard=256, max_locate_per_shard=1024, kb=2,
        kmer_table=kt, switchpoint=4)

    def occ_set(out, rid_all=None):
        v = np.asarray(out["valid"])
        r = np.asarray(out["rid"])[v]
        w = np.asarray(out["win_start"])[v]
        return set(zip(r.tolist(), w.tolist()))

    assert int(multi["overflow"]) == 0
    assert occ_set(single) == occ_set(multi)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_match_rlc_backend(small_index, rng):
    """The RLC (b-move) index shards through the same data-parallel path
    (the index pytree is replicated regardless of flavor)."""
    from columba_jax.dist import mesh as dmesh
    from columba_jax.index.bmove import BMoveIndex, build_bmove_from_codes

    genome, _ = small_index
    index = BMoveIndex.from_arrays(build_bmove_from_codes(genome))
    m = 80
    starts = rng.integers(0, len(genome) - m, size=16)
    reads = jnp.asarray(
        np.stack([genome[s:s + m] for s in starts]).astype(np.int32))
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), m, "edit")
    mesh = dmesh.make_data_mesh(8)
    out = dmesh.sharded_match(mesh, index, reads, sched, 256, 512, 2)
    single = pipeline.match_device_core(
        index, reads, sched, pipeline.device_tables(sched), 2048, 4096, 2)
    assert int(np.asarray(out["overflow"])) == 0
    assert int(np.asarray(out["total"])) == int(np.asarray(single["total"]))
