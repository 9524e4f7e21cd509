"""Mapping strategies: single-end ALL and BEST(+x) modes over read batches.

The batched analogue of the reference's ``SearchStrategy`` mapping modes
(reference: src/searchstrategy.cpp:495-535 ``matchApproxAllMap``,
:623-744 ``findBestAlignments``/``matchApproxBestPlusX``): ALL mode reports
every occurrence with ed <= k; BEST mode walks distance strata (with the
reference's stratum jumps: step 2 below distance 5, else 4) until the best
stratum is found, then reports occurrences within [best, best + x].

Strata run on the whole batch with per-read resolved masking — the batched
substitute for the reference's per-read early exit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from columba_jax.core import alphabet
from columba_jax.index.build import IndexArrays, decoded_text
from columba_jax.index.fmindex import FMIndex
from columba_jax.io import sam
from columba_jax.search import pipeline
from columba_jax.search.scheme import get_scheme

BEST_CUTOFF = 13  # reference BEST_CUTOFF_COLUMBA (src/definitions.h)


def get_max_ed(min_identity: int, seq_size: int, max_supported: int = 4) -> int:
    """reference: src/searchstrategy.h:1797-1806."""
    cutoff = (seq_size * (100 - min_identity)) // 100
    return min(BEST_CUTOFF, max_supported, cutoff)


_PARTS_PER_K = {
    "kuch1": lambda k: k + 1, "kuch2": lambda k: k + 2,
    "pigeon": lambda k: k + 1, "kianfar": lambda k: k + 1,
    "01*0": lambda k: k + 2, "minU": lambda k: k + 1,
    "columba": lambda k: k + 1, "naive": lambda k: 1,
}


def max_supported_k(scheme_name: str, m: int, metric: str = "edit") -> int:
    """Largest k whose schedule compiles for reads of length m: the family
    must define schemes for k and parts must be non-empty with the colMin
    register budget (schedule.MAX_REGS) respected; short parts use rotating
    registers (search/schedule.py), so the old part > 2k limit is gone."""
    from columba_jax.search.schedule import MAX_REGS

    family_max = {"kuch1": 4, "kuch2": 4, "pigeon": 12, "kianfar": 4,
                  "01*0": 4, "minU": 7, "columba": 13, "naive": 20}
    parts = _PARTS_PER_K.get(scheme_name, lambda k: k + 1)
    best = 0
    for k in range(1, family_max.get(scheme_name, 4) + 1):
        p = parts(k)
        min_part = m // p
        if min_part < 1:
            break
        if metric == "edit":
            # window length 2k+1 rows + lifetime ~ one part; worst-case
            # simultaneous registers ~ ceil((2k+1+min_part)/min_part)
            regs = -(-(2 * k + 1 + min_part) // min_part)
            if regs > MAX_REGS:
                break
        best = k
    return best


@dataclass
class MappingConfig:
    scheme_name: str = "kuch1"
    dynamic_selection: bool = False  # per-read scheme choice (reference -S columba default)
    probe_selection: bool = False  # force the probe even for builtin 'columba' (see _scheme_for)
    metric: str = "edit"
    mode: str = "best"        # "all" | "best"
    max_distance: int = 2     # ALL mode k (reference -e)
    best_plus_x: int = 0      # BEST +x strata
    min_identity: int = 95
    switchpoint: int = 4      # in-text crossover (reference -i, default 4)
    capacity: int | None = None
    max_locate: int | None = None  # None: scale with batch + spill retry
    kmer_table: object = None  # optional device seed table
    partitioning: str = "uniform"
    arrays: object = None      # host IndexArrays; enables cross-boundary
                               # occurrence trimming on multi-sequence texts


@dataclass
class MappedRead:
    """Final mapping result of one read."""

    occs: list = field(default_factory=list)  # list[pipeline.Occurrence]
    best: int | None = None
    n_best: int = 0


def _scheme_for(cfg: MappingConfig, k: int):
    """Resolve the scheme for one pass at cut k.

    The builtin 'columba' dynamic-selection set COLLAPSES to its base
    scheme (minU k<=7 / greedy above) unless probe selection is forced:
    per-read scheme choice is a per-read-DFS optimization (reference
    src/searchstrategy.h:2505-2537 picks the scheme whose critical search
    has the fewest exact matches, saving THAT READ's node budget) — under
    SPMD batching every lane marches in lockstep, so the masked combined
    pass costs the union of all schemes' searches and the choice saves
    nothing. Measured (16384x100bp, k=5): probe + combined masked pass
    1148 ms vs single minU 540 ms. The reported occurrence set is
    IDENTICAL either way (every scheme in the set is lossless at k).
    User-supplied selection folders (-d/-c) keep the true probe path.
    """
    if k == 0:
        return get_scheme(cfg.scheme_name, 0)
    if cfg.scheme_name == "columba":
        if cfg.probe_selection:
            from columba_jax.search.scheme import get_multi_scheme

            return get_multi_scheme("columba", k)
        return get_scheme("columba", k)
    if cfg.dynamic_selection:
        from columba_jax.search.scheme import get_multi_scheme

        return get_multi_scheme(cfg.scheme_name, k)
    return get_scheme(cfg.scheme_name, k)


def map_batch_all_start(index: FMIndex, reads: np.ndarray,
                        cfg: MappingConfig):
    """Dispatch ALL-mode matching of a batch; returns an opaque handle for
    map_batch_all_finish (lets an emission thread overlap the fetch +
    post-processing with the next batch's device work, the batched analogue of
    the reference's reader/worker/writer overlap)."""
    scheme = _scheme_for(cfg, cfg.max_distance)
    return pipeline.match_all_start(
        index, reads, scheme, metric=cfg.metric,
        capacity=cfg.capacity, max_locate=cfg.max_locate,
        kmer_table=cfg.kmer_table, partitioning=cfg.partitioning,
        switchpoint=cfg.switchpoint, host_arrays=cfg.arrays,
    )


def map_batch_all_finish(ctx, index: FMIndex, reads: np.ndarray,
                         cfg: MappingConfig, counters=None):
    """Fetch + post-process a dispatched batch -> (OccArray, stats)."""
    occs, stats = pipeline.match_all_finish(ctx)
    if counters is not None:
        counters.add_device_stats(stats)
    if cfg.arrays is not None and not getattr(cfg.arrays, "textless",
                                              False):
        kb = cfg.max_distance if cfg.metric == "edit" else 0
        occs = pipeline.apply_boundary_trim(occs, reads, cfg.arrays, kb,
                                            cfg.max_distance)
    return occs, stats


def _group_mapped(occs, n_reads: int) -> list[MappedRead]:
    """OccArray -> per-read MappedRead lists (compat representation for
    the paired-end path and tests; the fast SE path never builds these)."""
    out = [MappedRead() for _ in range(n_reads)]
    for o in occs:
        out[o.read_id].occs.append(o)
    for mr in out:
        if mr.occs:
            mr.best = min(o.distance for o in mr.occs)
            mr.n_best = sum(1 for o in mr.occs if o.distance == mr.best)
    return out


def map_batch_all(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
) -> list[MappedRead]:
    ctx = map_batch_all_start(index, reads, cfg)
    occs, _ = map_batch_all_finish(ctx, index, reads, cfg, counters)
    return _group_mapped(occs, len(reads))


def best_cutoff_for(cfg: MappingConfig, m: int) -> int:
    supported = max_supported_k(cfg.scheme_name, m, cfg.metric)
    return get_max_ed(cfg.min_identity, m, max(supported, 1))


def map_batch_best_start(index: FMIndex, reads: np.ndarray,
                         cfg: MappingConfig, counters=None):
    """Dispatch BEST(+x) matching; returns an opaque handle for
    map_batch_best_finish — the same start/finish split as ALL mode, so
    the CLI emitter thread overlaps fetch + post-processing with the next
    batch's device work (the reference's default mode must pipeline too).

    Single-pass cutoffs (<= 6) dispatch one ALL run here and filter in
    finish; the deep stratum ladder is inherently iterative (each stratum
    depends on the previous round's per-read best), so it runs to
    completion inside start and finish is a passthrough."""
    R, m = reads.shape
    cutoff = best_cutoff_for(cfg, m)
    if cutoff <= 6:
        if getattr(index, "textless", False):
            # textless RLC refuses k=0 and dynamic selection, so it keeps
            # the one-pass-at-cutoff shape (pipeline.py match_all_start)
            ctx = _dispatch_best(index, reads, cutoff, cfg)
            return dict(mode="single", ctx=ctx, cutoff=cutoff)
        # Escalating rungs (the SE analogue of the PE BEST rungs,
        # paired.map_pairs_best_start): one full pass at the cutoff pays
        # k=5-grade device work for every read while almost all reads
        # resolve at distance <= 2 — the reference's per-read ladder
        # early-exit (src/searchstrategy.cpp:676-712) exploits exactly
        # this. A read is final after a rung with cut c iff
        # best + x < c + 1 (any occurrence the rung missed has distance
        # > c >= best + x, so the [best, best+x] window is complete).
        # Only unresolved reads escalate, padded to pow2 lane counts to
        # bound the jit-variant set. Rung choice is a cost trade: a low
        # first rung only wins when it finalizes most reads (measured on
        # 1%-error 100 bp reads: ~37% resolve exactly, so a 0-rung pays
        # a full-width k=2 pass on top — rung 2 finalizes ~92% and the
        # cutoff pass runs at 1/8 width).
        rungs = [c for c in _pre_rungs() if c < cutoff] + [cutoff]
        ctx = _dispatch_best(index, reads, rungs[0], cfg)
        return dict(mode="rungs", ctx=ctx, cutoff=cutoff, rungs=rungs)
    return dict(mode="ladder",
                occs=map_batch_best_arr(index, reads, cfg, counters))


def _pre_rungs() -> tuple:
    """Pre-cutoff rung cuts (comma list via COLUMBA_JAX_BEST_RUNGS; empty
    = single full-cutoff pass). Default: NO pre-rungs for SE — measured
    on 1%-error 100 bp reads (k=5 cutoff, probe-free schemes): single
    pass 28.6k reads/s vs rung-(2,cutoff) 23.9k vs rung-(0,2,cutoff)
    ~12k. Escalation re-dispatches from the finish side, which serializes
    the emitter thread on device round trips; the device saving (k2 pass
    321 ms vs k5 540 ms, escalated tail at 1/8 width) does not cover the
    lost overlap. PE keeps its rungs: its (0,0) rung finalizes most pairs
    outright, so escalations are rare there."""
    import os

    v = os.environ.get("COLUMBA_JAX_BEST_RUNGS")
    if v is None:
        return ()
    return tuple(int(t) for t in v.split(",") if t.strip() != "")


def _dispatch_best(index, reads, cut, cfg):
    return pipeline.match_all_start(
        index, reads, _scheme_for(cfg, cut), metric=cfg.metric,
        capacity=cfg.capacity, max_locate=cfg.max_locate,
        kmer_table=cfg.kmer_table, partitioning=cfg.partitioning,
        switchpoint=cfg.switchpoint, host_arrays=cfg.arrays,
    )


def _pad_pow2(reads: np.ndarray, floor: int = 512) -> np.ndarray:
    """Pad a read sub-batch to a power-of-two row count (>= floor) by
    repeating row 0; pad-lane results are dropped by read_id filter."""
    n = len(reads)
    P = max(floor, 1 << (n - 1).bit_length())
    if P == n:
        return reads
    return np.concatenate([reads, np.repeat(reads[:1], P - n, axis=0)])


def _trim_full(occs, reads, cfg, cutoff):
    """Boundary trim with rung-invariant parameters (always the FULL
    cutoff): trim's eligibility windows and re-verify budget scale with
    kb, so pinning kb to the cutoff makes per-read trim results identical
    across rungs — the rung-finality argument needs that invariance."""
    if cfg.arrays is None or getattr(cfg.arrays, "textless", False):
        return occs
    kbs = cutoff if cfg.metric == "edit" else 0
    return pipeline.apply_boundary_trim(occs, reads, cfg.arrays, kbs,
                                        cutoff)


def map_batch_best_finish(handle, index: FMIndex, reads: np.ndarray,
                          cfg: MappingConfig, counters=None):
    """Fetch + filter a dispatched BEST batch -> OccArray (escalating
    unresolved reads through the remaining rungs)."""
    if handle["mode"] == "ladder":
        return handle["occs"]
    R, m = reads.shape
    cutoff = handle["cutoff"]
    x = cfg.best_plus_x
    if handle["mode"] == "single":        # textless one-pass path
        occs, stats = pipeline.match_all_finish(handle["ctx"])
        if counters is not None:
            counters.add_device_stats(stats)
        occs = _trim_full(occs, reads, cfg, cutoff)
        if not len(occs):
            return occs
        best1 = np.full(R, cutoff + 1, dtype=np.int64)
        np.minimum.at(best1, occs.read_id, occs.distance)
        rb = best1[occs.read_id]
        occs = occs.take(occs.distance <= np.minimum(rb + x, cutoff))
        o2 = np.lexsort((occs.begin, occs.end, occs.strand, occs.read_id))
        return occs.take(o2)
    rungs = handle["rungs"]
    ctx = handle["ctx"]
    sub_ids = np.arange(R)
    preads = reads
    parts: list = []
    for ri, c in enumerate(rungs):
        occs, stats = pipeline.match_all_finish(ctx)
        if counters is not None:
            counters.add_device_stats(stats)
        occs = _trim_full(occs, preads, cfg, cutoff)
        if len(preads) > len(sub_ids):    # drop pad-lane occurrences
            occs = occs.take(occs.read_id < len(sub_ids))
        best = np.full(len(sub_ids), cutoff + 1, dtype=np.int64)
        if len(occs):
            np.minimum.at(best, occs.read_id, occs.distance)
        last = ri == len(rungs) - 1
        final = (np.ones(len(sub_ids), dtype=bool) if last
                 else (best + x) < c + 1)
        if len(occs):
            keep = occs.take(final[occs.read_id])
            if len(keep):
                rb = best[keep.read_id]
                keep = keep.take(
                    keep.distance <= np.minimum(rb + x, cutoff))
                keep.read_id = sub_ids[keep.read_id]
                parts.append(keep)
        if last:
            break
        esc = np.nonzero(~final)[0]
        if not len(esc):
            break
        sub_ids = sub_ids[esc]
        preads = _pad_pow2(reads[sub_ids])
        ctx = _dispatch_best(index, preads, rungs[ri + 1], cfg)
    occs = pipeline.OccArray.concat(parts)
    if not len(occs):
        return occs
    o2 = np.lexsort((occs.begin, occs.end, occs.strand, occs.read_id))
    return occs.take(o2)


def map_batch_best_arr(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
):
    """BEST(+x) mapping with per-read stratum compaction: each stratum runs
    only the reads that still need it (resolved reads drop out — the batched
    substitute for the reference's per-read early exit), padded to
    power-of-two sizes so the set of compiled batch shapes stays bounded.

    Array-native: occurrences stay in OccArrays end to end. Returns the
    final best(+x)-filtered OccArray (read ids global to ``reads``).
    """
    R, m = reads.shape
    cutoff = best_cutoff_for(cfg, m)
    x = cfg.best_plus_x
    if cutoff <= 6:
        # Single-pass BEST: one ALL run at the cutoff, then filter each
        # read to [best, best+x]. Identical output set to the stratum
        # ladder (the union of explored strata IS the <= cutoff set), and
        # one full-batch pass replaces 3-4 compacted ladder rounds, whose
        # per-round dispatch/fetch/extract costs add up while the batched
        # device cost grows slowly with k. The reference's ladder exists
        # because ITS per-read
        # DFS cost explodes with k (src/searchstrategy.cpp:623-712);
        # the batched engine's does not. Deep cutoffs (long reads,
        # k up to 13) keep the ladder: one k=13 pass over every read
        # would do the explosion the ladder avoids.
        handle = map_batch_best_start(index, reads, cfg, counters)
        return map_batch_best_finish(handle, index, reads, cfg, counters)
    best = np.full(R, cutoff + 1, dtype=np.int64)
    explored = np.full(R, -1, dtype=np.int64)
    parts: list = []

    def run_stratum(k: int, idxs: np.ndarray):
        n_live = len(idxs)
        size = min(R, max(64, 1 << (n_live - 1).bit_length()))
        sub = np.concatenate(
            [idxs, np.full(size - n_live, idxs[0], dtype=idxs.dtype)])
        scheme = _scheme_for(cfg, k)
        occs, stats = pipeline.match_all(
            index, reads[sub], scheme, metric=cfg.metric,
            capacity=cfg.capacity, max_locate=cfg.max_locate,
            kmer_table=cfg.kmer_table, partitioning=cfg.partitioning,
            switchpoint=cfg.switchpoint, host_arrays=cfg.arrays,
        )
        if counters is not None:
            counters.add_device_stats(stats)
        if cfg.arrays is not None and not getattr(cfg.arrays, "textless",
                                                  False):
            kbs = k if cfg.metric == "edit" else 0
            occs = pipeline.apply_boundary_trim(occs, reads[sub],
                                                cfg.arrays, kbs, k)
        occs = occs.take(occs.read_id < n_live)  # drop padding lanes
        occs.read_id = idxs[occs.read_id]        # remap to global ids
        parts.append(occs)
        if len(occs):
            np.minimum.at(best, occs.read_id, occs.distance)
        explored[idxs] = np.maximum(explored[idxs], k)

    run_stratum(0, np.arange(R))
    while True:
        # per-read next stratum: reads with a best need their +x target,
        # others follow the reference ladder (searchstrategy.cpp:676-709:
        # k += x + (2 if k < 5 else 4)); resolved reads drop out
        has_best = best <= cutoff
        target = np.minimum(best + x, cutoff)
        step = np.where(explored < 5, 2, 4)
        ladder = np.where(explored == 0, max(x, 1),
                          np.minimum(explored + x + step, cutoff))
        nk = np.where(has_best, target, ladder)
        need = ((explored < cutoff)
                & np.where(has_best, explored < target, True))
        if not need.any():
            break
        for k in np.unique(nk[need]):
            run_stratum(int(k), np.nonzero(need & (nk == k))[0])

    allo = pipeline.OccArray.concat(parts)
    if not len(allo):
        return allo
    rb = best[allo.read_id]
    hi = np.minimum(rb + x, cutoff)
    allo = allo.take((rb <= cutoff) & (allo.distance >= rb)
                     & (allo.distance <= hi))
    if not len(allo):
        return allo
    # dedup across strata by (read, strand, end): min distance wins, first
    # collected wins ties (higher-k reruns rediscover lower-distance occs)
    ordidx = np.arange(len(allo))
    o = np.lexsort((ordidx, allo.distance, allo.end, allo.strand,
                    allo.read_id))
    first = np.empty(o.size, bool)
    first[0] = True
    rid_s, str_s, end_s = (allo.read_id[o], allo.strand[o], allo.end[o])
    first[1:] = ((rid_s[1:] != rid_s[:-1]) | (str_s[1:] != str_s[:-1])
                 | (end_s[1:] != end_s[:-1]))
    allo = allo.take(o[first])
    # final order (read, strand, end, begin)
    o2 = np.lexsort((allo.begin, allo.end, allo.strand, allo.read_id))
    return allo.take(o2)


def map_batch_best(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
) -> list[MappedRead]:
    occs = map_batch_best_arr(index, reads, cfg, counters)
    return _group_mapped(occs, len(reads))


def _final_redundancy_filter(finalized, max_ed):
    """The reference's non-redundancy pass on traceback-refined begins
    (reference: src/indexinterface.cpp:1451-1485): occurrences sorted by
    (begin, distance, text width); same begin -> keep the first; begins
    within 2*maxED -> keep the strictly better one (smaller distance, then
    strictly smaller width). finalized entries: (..., ed at [4], begin at
    [7]); per-strand groups are filtered independently."""
    out = []
    for strand in (0, 1):
        group = [f for f in finalized if f[0].strand == strand]
        group.sort(key=lambda f: (f[7], f[4], f[0].end - f[7]))
        kept = []
        prev_begin = prev_ed = prev_w = None
        for f in group:
            begin, ed, width = f[7], f[4], f[0].end - f[7]
            if kept:
                diff = abs(begin - prev_begin)
                if diff == 0:
                    continue
                if diff <= 2 * max_ed:
                    if ed > prev_ed or (ed == prev_ed and width >= prev_w):
                        continue
                    kept.pop()
            prev_begin, prev_ed, prev_w = begin, ed, width
            kept.append(f)
        out.extend(kept)
    return out


def emit_sam(
    records,
    mapped: list[MappedRead],
    arrays: IndexArrays,
    index: FMIndex,
    kb: int,
    mode: str = "best",
    xa_tag: bool = False,
    unmapped_records: bool = True,
    with_cigar: bool = True,
    counters=None,
) -> list[str]:
    """SAM lines for a batch (primary = best occurrence, others secondary;
    with xa_tag, secondaries fold into the primary's XA:Z: tag instead,
    reference: src/indexhelpers.h:418). with_cigar=False emits '*' CIGARs
    (reference -nC; the traceback still runs to refine begin positions)."""
    genome = decoded_text(arrays)
    starts = arrays.seq_starts
    # batch the traceback DP across every occurrence of the whole chunk
    # (the per-record numpy DP was the host hot spot)
    tasks = []          # (patterns, windows) in emission order
    task_meta = []      # (rec_i, o, seq_codes, qual, w_lo)
    for rec_i, (rec, mr) in enumerate(zip(records, mapped)):
        for o in sorted(mr.occs, key=lambda o: (o.distance, o.begin,
                                                o.strand)):
            seq_codes = (rec.codes if o.strand == 0
                         else alphabet.revcomp(rec.codes))
            qual = rec.qual if o.strand == 0 else rec.qual[::-1]
            # clamp the traceback window to the occurrence's sequence so a
            # begin never re-crosses a boundary the trim pass resolved
            s_lo = int(starts[np.searchsorted(starts, o.end - 1,
                                              side="right") - 1])
            w_lo = max(s_lo, o.end - len(rec.codes) - kb)
            tasks.append((seq_codes, genome[w_lo:o.end]))
            task_meta.append((rec_i, o, seq_codes, qual, w_lo))
    tb = sam.traceback_batch([t[0] for t in tasks], [t[1] for t in tasks],
                             kb)
    if counters is not None:
        counters.cigars_computed += len(tasks)
    per_rec: dict[int, list] = {}
    for (rec_i, o, seq_codes, qual, w_lo), (begin, cigar, ed) in zip(
            task_meta, tb):
        begin += w_lo
        sidx = int(np.searchsorted(starts, begin, side="right") - 1)
        sidx = max(0, min(sidx, len(arrays.seq_names) - 1))
        pos1 = begin - int(starts[sidx]) + 1
        per_rec.setdefault(rec_i, []).append(
            (o, seq_codes, qual, cigar, ed, sidx, pos1, begin))

    lines = []
    for rec_i, (rec, mr) in enumerate(zip(records, mapped)):
        if not mr.occs:
            if unmapped_records:
                lines.append(sam.unmapped_record(rec.name, rec.codes, rec.qual))
            continue
        finalized = _final_redundancy_filter(per_rec[rec_i], kb)
        # primary = best distance, earliest begin
        finalized.sort(key=lambda f: (f[4], f[7], f[0].strand))
        finalized = [f[:7] for f in finalized]
        if not with_cigar:
            finalized = [(o, sq, q, "*", ed, sx, pp)
                         for o, sq, q, _, ed, sx, pp in finalized]
        best_ed = min((f[4] for f in finalized), default=0)
        n_best = sum(1 for f in finalized if f[4] == best_ed)
        mq = sam.mapq(max(n_best, 1))
        if xa_tag:
            o, seq_codes, qual, cigar, ed, sidx, pos1 = finalized[0]
            flag = 16 if o.strand else 0
            line = sam.record(
                rec.name, flag, arrays.seq_names[sidx], pos1, mq, cigar,
                seq_codes, qual, ed,
            ).rstrip("\n")
            if len(finalized) > 1:
                xa = "".join(
                    f"{arrays.seq_names[sx]},{'-' if oo.strand else '+'}{pp},{cg},{e};"
                    for oo, _, _, cg, e, sx, pp in finalized[1:]
                )
                line += f"\tX0:i:{mr.n_best}\tX1:i:{len(finalized)-mr.n_best}\tXA:Z:{xa}"
            lines.append(line + "\n")
        else:
            for rank_i, (o, seq_codes, qual, cigar, ed, sidx, pos1) in enumerate(finalized):
                flag = (16 if o.strand else 0) | (256 if rank_i > 0 else 0)
                lines.append(
                    sam.record(
                        rec.name, flag, arrays.seq_names[sidx], pos1,
                        # reference getMapQ: every best-distance record gets
                        # the MAPQ, secondary or not; others get 0
                        mq if ed == best_ed else 0, cigar, seq_codes, qual,
                        ed,
                    )
                )
    return lines


def emit_sam_textless(
    records,
    mapped: list[MappedRead],
    arrays,
    unmapped_records: bool = True,
    counters=None,
) -> list[str]:
    """SAM lines without genome text: '*' CIGARs, begins straight from the
    toehold/phi locate, distances from the search (the textless RLC
    reporting mode — the reference's RLC flavor likewise defaults to no
    CIGAR, src/parameters/alignparameters.cpp:131-160)."""
    starts = arrays.seq_starts
    lines = []
    for rec, mr in zip(records, mapped):
        if not mr.occs:
            if unmapped_records:
                lines.append(sam.unmapped_record(rec.name, rec.codes,
                                                 rec.qual))
            continue
        occs = sorted(mr.occs, key=lambda o: (o.distance, o.begin,
                                              o.strand))
        best_ed = occs[0].distance
        n_best = sum(1 for o in occs if o.distance == best_ed)
        mq = sam.mapq(max(n_best, 1))
        for rank_i, o in enumerate(occs):
            seq_codes = (rec.codes if o.strand == 0
                         else alphabet.revcomp(rec.codes))
            qual = rec.qual if o.strand == 0 else rec.qual[::-1]
            sidx = int(np.searchsorted(starts, o.begin, side="right") - 1)
            sidx = max(0, min(sidx, len(arrays.seq_names) - 1))
            pos1 = o.begin - int(starts[sidx]) + 1
            flag = (16 if o.strand else 0) | (256 if rank_i > 0 else 0)
            lines.append(sam.record(
                rec.name, flag, arrays.seq_names[sidx], pos1,
                mq if o.distance == best_ed else 0, "*", seq_codes, qual,
                o.distance,
            ))
    return lines


def emit_rhs(
    records,
    mapped: list[MappedRead],
    arrays: IndexArrays,
) -> list[str]:
    """Read-hit-summary lines: readID\t(seq,dist);(seq,dist)...
    (reference: src/searchstrategy.h:1651-1685, src/indexhelpers.h:690-704).
    """
    starts = arrays.seq_starts
    lines = []
    for rec, mr in zip(records, mapped):
        if not mr.occs:
            lines.append(f"{rec.name}\n")
            continue
        combos = set()
        for o in mr.occs:
            # assign by the (exact) end: begin is a pre-traceback estimate
            sidx = int(np.searchsorted(starts, o.end - 1, side="right") - 1)
            sidx = max(0, min(sidx, len(arrays.seq_names) - 1))
            combos.add((o.distance, sidx))
        parts = [
            f"({arrays.seq_names[sidx]},{dist})"
            for dist, sidx in sorted(combos)
        ]
        lines.append(rec.name + "\t" + ";".join(parts) + "\n")
    return lines
