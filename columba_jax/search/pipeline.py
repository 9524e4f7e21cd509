"""End-to-end matching pipeline: executor -> locate -> verify -> occurrences.

The batched analogue of the reference's SearchStrategy mapping loop
(reference: src/searchstrategy.cpp:425-535 ``matchWithSearches`` /
``matchApproxAllMap``): run the compiled scheme over the frontier, expand
candidate SA ranges to text positions (two-phase count-then-gather), verify
in text, and post-process (dedup + redundancy filter) into occurrences.

Device part returns fixed-shape tensors; occurrence extraction runs on host
(cheap: candidates << reads) — mirroring the reference's split where SAM
emission is host-side anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.core import alphabet
from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import extend, locate, verify
from columba_jax.search import executor, schedule
from columba_jax.search.scheme import SearchScheme


@dataclass
class Occurrence:
    """One verified text occurrence of a read."""

    read_id: int
    strand: int          # 0 fwd, 1 revcomp
    begin: int           # text start (filled by finalize/traceback)
    end: int             # text end (exclusive)
    distance: int

    def key(self):
        return (self.read_id, self.strand, self.end, self.begin)


class OccArray:
    """Occurrences as struct-of-arrays (the host hot path keeps every
    occurrence in numpy end to end; the reference's per-occurrence TextOcc
    objects have no analogue here — that was the round-2 bottleneck).

    Iteration / indexing yield :class:`Occurrence` views for compatibility
    with list-based callers (tests, the paired-end orchestration)."""

    __slots__ = ("read_id", "strand", "begin", "end", "distance")

    def __init__(self, read_id, strand, begin, end, distance):
        self.read_id = np.asarray(read_id, dtype=np.int64)
        self.strand = np.asarray(strand, dtype=np.int64)
        self.begin = np.asarray(begin, dtype=np.int64)
        self.end = np.asarray(end, dtype=np.int64)
        self.distance = np.asarray(distance, dtype=np.int64)

    @staticmethod
    def empty() -> "OccArray":
        z = np.zeros(0, dtype=np.int64)
        return OccArray(z, z, z, z, z)

    @staticmethod
    def from_list(occs) -> "OccArray":
        if not occs:
            return OccArray.empty()
        return OccArray(
            np.fromiter((o.read_id for o in occs), np.int64, len(occs)),
            np.fromiter((o.strand for o in occs), np.int64, len(occs)),
            np.fromiter((o.begin for o in occs), np.int64, len(occs)),
            np.fromiter((o.end for o in occs), np.int64, len(occs)),
            np.fromiter((o.distance for o in occs), np.int64, len(occs)),
        )

    @staticmethod
    def concat(parts: list) -> "OccArray":
        parts = [p for p in parts if len(p)]
        if not parts:
            return OccArray.empty()
        return OccArray(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in OccArray.__slots__))

    def take(self, idx) -> "OccArray":
        return OccArray(*(getattr(self, f)[idx] for f in OccArray.__slots__))

    def __len__(self):
        return self.read_id.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return Occurrence(int(self.read_id[i]), int(self.strand[i]),
                              int(self.begin[i]), int(self.end[i]),
                              int(self.distance[i]))
        return self.take(i)


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

NEG_T_HOST = 2**32 - 2**17  # mirror of ops/verify.NEG_T


def signed_positions(a) -> np.ndarray:
    """uint32 device positions -> int64 host values (wrapped negatives in
    the guard band [2^32 - 2^17, 2^32) restored to their signed meaning)."""
    v = np.asarray(a).astype(np.int64)
    return np.where(v >= NEG_T_HOST, v - 2**32, v)


@jax.jit
def _widen_batch(b):
    """uint8 wire codes -> int32 device codes (see match_all_start)."""
    return b.astype(jnp.int32)


def crossover_caps(capacity: int, max_locate: int, switchpoint: int):
    """Derived in-text crossover sizing (itv_cap, split_step, capacity2),
    shared by match_all and dist.mesh so the two paths cannot drift."""
    if switchpoint > 0:
        return int(max_locate), 2, max(1024, int(capacity) // 16)
    return 0, 0, 0


def stage_candidates(res, sched, dyn):
    """Unified candidate list: completed frontier nodes + in-text-crossover
    entries [f_lo, f_hi, ids, back_depth] -> (c_lo, c_hi, c_rid, c_estb)."""
    S = sched.num_searches
    fr_lo = jnp.where(res.done, res.ranges[:, 0], 0)
    fr_hi = jnp.where(res.done, res.ranges[:, 1], 0)
    fr_rid = res.rid
    fr_sid = res.sid
    if dyn is not None:
        lane_fr = fr_rid * S + fr_sid
        fr_estb = dyn["t_back"][lane_fr] - dyn["pivot"][lane_fr]
    else:
        fr_estb = executor.select_by(
            fr_sid,
            [int(t) - int(p) for t, p in zip(sched.t_back, sched.pivot)])

    itv_rows = res.itv
    iv_valid = jnp.arange(itv_rows.shape[0]) < res.itv_count
    iv_lo = jnp.where(iv_valid, itv_rows[:, 0], 0)
    iv_hi = jnp.where(iv_valid, itv_rows[:, 1], 0)
    iv_ids = itv_rows[:, 2].astype(jnp.int32)  # ids/depth are small ints
    iv_db = itv_rows[:, 3].astype(jnp.int32)   # stored in the uint32 buffer
    iv_rid = iv_ids // S
    iv_sid = iv_ids % S
    if dyn is not None:
        iv_estb = iv_db - dyn["pivot"][iv_ids]
    else:
        iv_estb = iv_db - executor.select_by(
            iv_sid, [int(p) for p in sched.pivot])

    c_lo = jnp.concatenate([fr_lo, iv_lo])
    c_hi = jnp.concatenate([fr_hi, iv_hi])
    c_rid = jnp.concatenate([fr_rid, iv_rid])
    c_estb = jnp.concatenate([fr_estb, iv_estb])
    return c_lo, c_hi, c_rid, c_estb


def stage_expand(c_lo, c_hi, max_locate: int):
    """Two-phase expansion: candidate ranges -> flat rows (cap max_locate).

    Ranges are uint32. Per-candidate widths are clamped at max_locate + 1
    before the cumsum: rows beyond max_locate are dropped anyway, the clamp
    keeps the uint32 running sum from wrapping on pathological repeat
    ranges, and a clamped candidate still forces total > max_locate so the
    truncation flag cannot be suppressed.

    Returns (rows, cand, valid, total)."""
    c_lo = c_lo.astype(jnp.uint32)
    c_hi = c_hi.astype(jnp.uint32)
    widths = jnp.where(c_hi > c_lo, c_hi - c_lo, jnp.uint32(0))
    widths = jnp.minimum(widths, jnp.uint32(max_locate + 1))
    offsets = jnp.cumsum(widths)
    total = offsets[-1]
    j = jnp.arange(max_locate, dtype=jnp.int32).astype(jnp.uint32)
    cand = jnp.searchsorted(offsets, j, side="right").astype(jnp.int32)
    cand = jnp.clip(cand, 0, widths.shape[0] - 1)
    base = offsets[cand] - widths[cand]
    valid = j < jnp.minimum(total, jnp.uint32(max_locate))
    rows = jnp.where(valid, c_lo[cand] + (j - base), 0)
    return rows, cand, valid, total


def stage_dedup(rid, win_start, valid, max_locate: int, max_verify: int):
    """Dedup (read, window) pairs before the banded verification: different
    searches (and the in-text crossover) rediscover the same region many
    times over (the reference dedups FM-occurrences the same way,
    src/indexinterface.cpp:1381 eraseDoublesFM).

    win_start is uint32 (wrapped-negative near the text start); invalidity
    is carried by the rid sentinel alone, the win sentinel only sorts
    invalid rows last within their (nonexistent) group.

    Returns (rid_v, win_v, vlive, n_uniq)."""
    L = max_locate
    big = jnp.int32(1 << 30)
    rid_m = jnp.where(valid, rid, big)
    win_m = jnp.where(valid, win_start.astype(jnp.uint32),
                      jnp.uint32(0xFFFFFFFF))
    order = jnp.lexsort((win_m, rid_m))
    rid_s = rid_m[order]
    win_s = win_m[order]
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (rid_s[1:] != rid_s[:-1]) | (win_s[1:] != win_s[:-1]),
    ])
    uniq = first & (rid_s < big)
    upos = jnp.cumsum(uniq.astype(jnp.int32)) - 1
    n_uniq = upos[-1] + 1
    V = max_verify
    dest = jnp.where(uniq, jnp.minimum(upos, V), V)
    src = jnp.full((V + 1,), L, jnp.int32)
    src = src.at[dest].set(jnp.arange(L, dtype=jnp.int32), mode="drop")[:V]
    vlive = src < L
    srcc = jnp.where(vlive, src, 0)
    rid_v = jnp.where(vlive, rid_s[srcc], 0)
    win_v = jnp.where(vlive, win_s[srcc], 0)
    return rid_v, win_v, vlive, n_uniq


def match_device_core(
    index: FMIndex,
    reads: jax.Array,
    sched: schedule.Schedule,
    tables: dict | None,
    capacity: int,
    max_locate: int,
    kb: int,
    kmer_table: jax.Array | None = None,
    search_mask: jax.Array | None = None,
    dyn: dict | None = None,
    switchpoint: int = 0,
    itv_cap: int = 0,
    split_step: int = 0,
    capacity2: int = 0,
    max_verify: int | None = None,
    itv_min_depth: int = 16,
    ex_split: int = 0,
    ex_cap: int = 0,
):
    if max_verify is None:
        max_verify = max_locate
    """Device-side match step (unjitted; see also dist.mesh for the
    shard_map'd multi-chip version)."""
    res = executor.run_scheme(index, reads, sched, capacity, kmer_table,
                              search_mask, dyn, switchpoint, itv_cap,
                              split_step, capacity2,
                              itv_min_depth=itv_min_depth, tables=tables,
                              ex_split=ex_split, ex_cap=ex_cap)

    c_lo, c_hi, c_rid, c_estb = stage_candidates(res, sched, dyn)
    rows, cand, valid, total = stage_expand(c_lo, c_hi, max_locate)

    pos = locate.locate_rows(index, rows)  # uint32 text positions
    # est/win_start stay uint32: adding the (possibly negative) int32 back-
    # depth estimate wraps modulo 2^32, which is exactly the wrapped-negative
    # convention gather_window expects (ops/verify.py NEG_T)
    est = pos + c_estb[cand].astype(jnp.uint32)
    win_start = est - jnp.uint32(kb)
    rid = c_rid[cand]

    rid_v, win_v, vlive, n_uniq = stage_dedup(
        rid, win_start, valid, max_locate, max_verify)

    final_rows = verify.verify_window(index, reads, rid_v, win_v, kb)

    return dict(
        rid=rid_v,
        win_start=win_v,
        final_rows=final_rows,
        valid=vlive,
        total=total,
        n_unique=n_uniq,
        overflow=res.overflow,
        nodes_visited=res.nodes_visited,
        itv_started=res.itv_count,
        searches_started=res.searches_started,
    )


_match_device = partial(
    jax.jit,
    static_argnames=("sched", "capacity", "max_locate", "kb", "switchpoint",
                     "itv_cap", "split_step", "capacity2", "max_verify",
                     "itv_min_depth", "ex_split", "ex_cap"),
)(match_device_core)


def _match_device_dyn_core(index, batch, kmer_table, search_mask, *,
                           sched, scheme, st, m, metric, capacity,
                           max_locate, kb, switchpoint, itv_cap,
                           split_step, capacity2, ex_split, ex_cap):
    """Dynamic partitioning fused with the match step: ONE compiled
    program per (shape, scheme) computes the greedy partition scan, the
    per-read schedule tables and the frontier search. The unfused version
    dispatched the m-step partition scan eagerly (thousands of small
    kernel launches + a host sync per batch)."""
    from columba_jax.search import dynschedule

    pts = dynschedule.dynamic_partition(index, batch, scheme, kmer_table)
    pts_dev = dynschedule.clamp_partition(pts, m, kb)
    dyn = dynschedule.build_tables(st, pts_dev, batch)
    return match_device_core(
        index, batch, sched, None, capacity, max_locate, kb,
        kmer_table, search_mask, dyn, switchpoint, itv_cap, split_step,
        capacity2, ex_split=ex_split, ex_cap=ex_cap)


_match_device_dyn = partial(
    jax.jit,
    static_argnames=("sched", "scheme", "st", "m", "metric", "capacity",
                     "max_locate", "kb", "switchpoint", "itv_cap",
                     "split_step", "capacity2", "ex_split", "ex_cap"),
)(_match_device_dyn_core)


# SchemeStatic instances cached per (scheme, m, metric) so the fused-dyn
# jit (which takes st as a by-identity static argument) does not retrace
# per batch.
_SCHEME_STATIC_CACHE: dict = {}


def _scheme_static_cached(scheme, m: int, metric: str):
    from columba_jax.search import dynschedule

    key = (scheme, m, metric)
    ent = _SCHEME_STATIC_CACHE.get(key)
    if ent is None:
        ent = dynschedule.scheme_static(scheme, m, metric)
        _SCHEME_STATIC_CACHE[key] = ent
    return ent


# Schedule tables are jit ARGUMENTS (see executor.host_tables);
# device-put once per schedule. Keyed by
# id() with the schedule kept strongly referenced so ids can't be reused.
_dev_tables_cache: dict = {}


def device_tables(sched: schedule.Schedule) -> dict:
    ent = _dev_tables_cache.get(id(sched))
    if ent is None or ent[0] is not sched:
        tbl = {kk: jnp.asarray(v)
               for kk, v in executor.host_tables(sched).items()}
        _dev_tables_cache[id(sched)] = (sched, tbl)
        return tbl
    return ent[1]


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

_SCHED_CACHE: dict = {}


def compile_cached(scheme: SearchScheme, m: int, metric: str,
                   kmer_k: int = 0,
                   partitioning: str = "uniform") -> schedule.Schedule:
    key = (scheme, m, metric, kmer_k, partitioning)
    if key not in _SCHED_CACHE:
        partition = None
        if partitioning == "static" and scheme.static_fracs:
            partition = schedule.static_partition(m, scheme.static_fracs)
        _SCHED_CACHE[key] = schedule.compile_schedule(
            scheme, m, partition=partition, metric=metric, kmer_k=kmer_k)
    return _SCHED_CACHE[key]


def part_exact_ranges(
    index: FMIndex, reads: jax.Array, pts, kmer_table=None
) -> jax.Array:
    """Bidirectional exact-match ranges of every partition part, batched.

    reads: (R, m) int32; pts: part boundaries (p+1,). Returns (R, p, 4).
    The analogue of the reference's calculateExactMatchRanges
    (src/searchstrategy.cpp:158-190); feeds dynamic scheme selection and
    dynamic partitioning.
    """
    R, m = reads.shape
    pl = [int(x) for x in pts]
    p = len(pl) - 1
    lens = [pl[i + 1] - pl[i] for i in range(p)]
    maxlen = max(lens)
    # patterns (R*p, maxlen): part i of read r, padded with 5
    pats = np.full((p, maxlen), -1, dtype=np.int64)
    for i in range(p):
        pats[i, :lens[i]] = np.arange(pl[i], pl[i + 1])
    pos = jnp.asarray(pats)                              # (p, maxlen)
    chars = jnp.where(
        (pos >= 0)[None], reads[:, jnp.clip(pos, 0, m - 1)], 5
    )                                                    # (R, p, maxlen)
    lengths = jnp.asarray(lens, dtype=jnp.int32)
    flat = chars.reshape(R * p, maxlen).astype(jnp.int32)
    flat_len = jnp.broadcast_to(lengths[None], (R, p)).reshape(-1)
    rng = extend.exact_match(index, flat, flat_len)
    return rng.reshape(R, p, -1)  # last dim = index.range_width (4 or 8)


def select_schemes(
    index: FMIndex,
    batch: jax.Array,
    schemes: list[SearchScheme],
    kmer_table=None,
) -> tuple[SearchScheme, np.ndarray, np.ndarray]:
    """Dynamic per-read scheme selection.

    Returns (combined scheme, search_mask (R, S_total) bool, choice (R,)).
    Selection rule mirrors the reference (src/searchstrategy.h:2505-2537):
    pick the scheme whose critical search starts at the part with the
    fewest exact matches; fall back to scheme 0 when the total exact count
    is <= #parts.
    """
    k = schemes[0].k
    p = schemes[0].num_parts
    m = batch.shape[1]
    pts = schedule.uniform_partition(m, p)
    ranges = np.asarray(part_exact_ranges(index, batch, pts, kmer_table))
    widths = (ranges[:, :, 1].astype(np.int64)
              - ranges[:, :, 0].astype(np.int64))        # (R, p)
    crit = np.array([sc.critical_part_index for sc in schemes])
    crit_w = widths[:, crit]                             # (R, n_schemes)
    choice = np.argmin(crit_w, axis=1)
    choice = np.where(widths.sum(axis=1) <= p, 0, choice)

    all_searches = tuple(s for sc in schemes for s in sc.searches)
    combined = SearchScheme(all_searches, k=k, name="+".join(sc.name for sc in schemes))
    scheme_of = np.concatenate([
        np.full(len(sc.searches), i) for i, sc in enumerate(schemes)
    ])
    mask = scheme_of[None, :] == choice[:, None]         # (R, S_total)
    return combined, mask, choice


def match_all(*args, **kwargs) -> tuple["OccArray", dict]:
    """ALL-mode matching (synchronous): dispatch + fetch + post-process."""
    return match_all_finish(match_all_start(*args, **kwargs))


# adaptive locate-cap hint: batches in auto mode start at the largest cap
# an earlier batch *of the same index* had to grow to (lossless either
# way — this only skips predictable 4x-retry round trips + recompiles).
# Keyed weakly per index so one repeat-rich workload (pan genome, ~20x
# locate fan-out) does not permanently inflate device buffers and jit
# variants for every other index aligned in the same long-lived process.
import weakref

_ML_HINT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _ml_hint_get(index) -> int:
    try:
        return _ML_HINT.get(index, 0)
    except TypeError:          # unhashable/unweakrefable index stand-ins
        return 0


def _ml_hint_bump(index, ml: int) -> None:
    try:
        _ML_HINT[index] = max(_ML_HINT.get(index, 0), ml)
    except TypeError:
        pass


def match_all_start(
    index: FMIndex,
    reads_codes: np.ndarray,
    scheme: SearchScheme,
    metric: str = "edit",
    capacity: int | None = None,
    max_locate: int | None = None,
    both_strands: bool = True,
    redundancy_filter: bool = True,
    kmer_table=None,
    partitioning: str = "uniform",
    partition_pts=None,
    switchpoint: int = 0,
    ex_split: int = 0,
    ex_cap: int = 0,
    host_arrays=None,
    _force_scheme_path: bool = False,
) -> tuple[OccArray, dict]:
    """ALL-mode matching of a read batch: every occurrence with ed <= k.

    reads_codes: (R, m) uint8 codes. Returns (occurrences, stats).
    """
    R, m = reads_codes.shape
    k = scheme[0].k if isinstance(scheme, (list, tuple)) else scheme.k
    kb = k if metric == "edit" else 0
    if both_strands:
        rc = alphabet.revcomp(reads_codes, axis=-1)
        batch = np.concatenate([reads_codes, rc]).astype(np.uint8)
    else:
        batch = reads_codes.astype(np.uint8)
    # ship codes as uint8 (4x fewer bytes than int32 over the host->device
    # link) and widen on device
    batch_dev = _widen_batch(jnp.asarray(batch))

    if getattr(index, "textless", False):
        if isinstance(scheme, (list, tuple)):
            # per-read selection is perf-only (every scheme in a
            # collection is lossless at k, so the reported set is
            # identical); the textless flavor runs the collection's first
            # scheme instead of the probe + masked combined pass
            scheme = scheme[0]
            k = scheme.k
        # k == 0 runs the exact scheme through the same frontier-only
        # pass: done lanes carry toeholds, phi enumerates the range, and
        # with no indels the extent start IS the exact begin
        if host_arrays is None or getattr(host_arrays, "phi_fwd",
                                          None) is None:
            raise ValueError("textless RLC matching needs host_arrays "
                             "with phi tables")
        sched = compile_cached(scheme, m, metric, kmer_k=0,
                               partitioning="uniform")
        if capacity is None:
            capacity = max(1024, batch.shape[0] * sched.num_searches // 2)
        occs_stats = _match_textless(index, host_arrays, batch_dev, R, k,
                                     kb, sched, capacity,
                                     auto_capacity=True)
        return dict(result=occs_stats)

    # locate/verify capacities must scale with the batch: a fixed cap
    # silently truncates stage_expand at larger batch sizes (measured: the
    # k=4 100k-read matrix run dropped 44% of reads at batch 16384 with the
    # old fixed 1<<16). Auto-sized caps also arm the lossless spill retry
    # in match_all_finish.
    auto_locate = max_locate is None
    if auto_locate:
        # warm-start from the largest cap a previous batch grew to: on
        # repeat-rich genomes (pan workload: every locus ~20x) the 4x
        # spill-retry loop otherwise re-runs AND re-compiles (capacity is
        # a static jit arg) for every batch — measured minutes of compile
        # per run on the 20x pan genome before this hint existed
        max_locate = max(1 << 16, 4 * batch.shape[0], _ml_hint_get(index))

    if (k == 0 and not _force_scheme_path
            and (kmer_table is None or switchpoint <= 0)):
        # plain-scan fallback: without a seed table or with the crossover
        # off, the dedicated exact pass is the best shape. With both
        # available, k=0 runs through the scheme executor instead (below):
        # the 12-mer seed + in-text crossover replace most of the m-step
        # backward FM scan with a short ranked scan + text verify
        # (measured 16384x100bp: 315 ms -> ~180 ms, identical output).
        # Async dispatch either way: the fetch (+ lossless spill retries)
        # happens in match_all_finish, so a k=0 start does NOT block the
        # dispatch thread on device completion — the BEST rung-0 pass and
        # the PE rung-0 sides rely on this to pipeline with emission.
        out = _exact_device(index, batch_dev, int(max_locate))
        return dict(exact=dict(out=out, batch=batch_dev, R=R,
                               max_locate=max_locate,
                               auto_locate=auto_locate, index=index))

    from columba_jax.index.kmer import table_k

    search_mask = None
    if isinstance(scheme, (list, tuple)):
        scheme, mask_np, _ = select_schemes(
            index, batch_dev, list(scheme), kmer_table)
        search_mask = jnp.asarray(mask_np)

    dyn = None
    fused_dyn = False
    n_parts = scheme.num_parts
    if (partitioning == "dynamic" and partition_pts is None
            and m < n_parts * (2 * kb + 1)):
        # parametric schedules require every part >= 2*kb+1 (the overshoot
        # construction); when the read cannot fit that, fall back to the
        # static compiler's short-part path (rotating colMin registers)
        partitioning = "uniform"
    if partitioning == "dynamic" and partition_pts is None:
        # fused path: partition + table build + match compile into ONE
        # program (the eager version dispatched the ~m-step partition scan
        # as thousands of small kernels plus a host sync per batch)
        from columba_jax.search import dynschedule

        st = _scheme_static_cached(scheme, m, metric)
        dyn = "fused"
        fused_dyn = True
    elif partition_pts is not None:
        from columba_jax.search import dynschedule

        st = _scheme_static_cached(scheme, m, metric)
        pts_dev = dynschedule.clamp_partition(
            jnp.asarray(partition_pts, dtype=jnp.int32), m, kb)
        dyn = dynschedule.build_tables(st, pts_dev, batch_dev)

    sched = compile_cached(scheme, m, metric,
                           kmer_k=(table_k(kmer_table)
                                   if kmer_table is not None
                                   and dyn is None else 0),
                           partitioning="uniform" if dyn is not None
                           else partitioning)
    auto_capacity = capacity is None
    if auto_capacity:
        # tight frontier: exact-prefix deaths are compacted away at init,
        # and an overflow triggers one retry at 4x. Under dynamic scheme
        # selection only one scheme's searches are live per read.
        live_s = sched.num_searches
        if search_mask is not None:
            live_s = int(np.asarray(search_mask).sum(axis=1).max())
        # /8: seeded exact-prefix phases kill the vast majority of
        # (read, search) lanes before the band phase (measured: 16384-read
        # k=2 batches fit in cap 16384 with overflow 0, and device time
        # grows ~1.3x from cap 16k to 131k). The lossless worst case is
        # covered by the 4x overflow retry in match_all_finish.
        # With the crossover OFF (-i 0) nothing drains mid-scan, so exact
        # -prefix survivors occupy the frontier all the way to completion:
        # measured ~40% of L live concurrently at k=4 (profile_band.py) —
        # /8 would overflow-retry every batch, tripling device time. /2
        # holds the measured worst case with 20% headroom.
        div = 2 if switchpoint == 0 else 8
        capacity = max(1024, batch.shape[0] * live_s // div)
    if (switchpoint == 0 and ex_split == 0 and kmer_table is not None
            and dyn is None and sched.kmer_k > 0 and sched.e_max > 8):
        # two-stage exact loop for the band path too: with no crossover
        # the exact phase otherwise runs all E steps at the full R*S lane
        # count; the k-mer seed + 8 steps kill most random-hit lanes, so
        # the tail runs compacted (same lossless overflow-retry contract)
        ex_split, ex_cap = 8, capacity

    def run(cap, ecap, ml):
        itv_cap, split_step, cap2 = crossover_caps(cap, ml, switchpoint)
        if fused_dyn:
            return _match_device_dyn(
                index, batch_dev, kmer_table, search_mask,
                sched=sched, scheme=scheme, st=st, m=m, metric=metric,
                capacity=int(cap), max_locate=int(ml), kb=kb,
                switchpoint=int(switchpoint), itv_cap=itv_cap,
                split_step=split_step, capacity2=cap2,
                ex_split=int(ex_split), ex_cap=int(ecap))
        return _match_device(
            index,
            batch_dev,
            sched,
            device_tables(sched) if dyn is None else None,
            int(cap),
            int(ml),
            kb,
            kmer_table,
            search_mask,
            dyn,
            int(switchpoint),
            itv_cap,
            split_step,
            cap2,
            ex_split=int(ex_split),
            ex_cap=int(ecap),
        )

    out = run(capacity, ex_cap, max_locate)
    return dict(out=out, run=run, capacity=capacity, ex_cap=ex_cap,
                auto_capacity=auto_capacity, auto_locate=auto_locate,
                R=R, m=m, k=k, kb=kb, index=index,
                redundancy_filter=redundancy_filter, max_locate=max_locate)


def fetch_tree(tree):
    """Fetch a pytree of device arrays with ONE overlapped transfer pass.

    Sequential np.asarray per leaf waits for each copy in turn; starting
    all device->host copies before consuming any overlaps them."""
    leaves, treedef = jax.tree.flatten(tree)
    for v in leaves:
        if hasattr(v, "copy_to_host_async"):
            v.copy_to_host_async()
    return jax.tree.unflatten(treedef, [np.asarray(v) for v in leaves])


def match_all_finish(ctx) -> tuple[OccArray, dict]:
    """Fetch + post-process a match_all_start dispatch (may run on an
    emission worker thread while the main thread dispatches the next
    batch)."""
    if "result" in ctx:
        return ctx["result"]
    if "exact" in ctx:
        return _match_exact_finish(ctx["exact"])
    out = fetch_tree(ctx["out"])
    cap, ecap, ml = ctx["capacity"], ctx["ex_cap"], ctx["max_locate"]
    n_retries = 0
    for _ in range(3):
        # lossless retries: frontier/compaction overflow -> 4x capacities;
        # locate/verify spill (stage_expand or stage_dedup truncated) ->
        # 4x max_locate. Only auto-sized knobs retry — an explicit
        # capacity/max_locate is a measurement contract.
        grow_cap = ctx["auto_capacity"] and int(out["overflow"]) > 0
        grow_ml = ctx["auto_locate"] and (
            int(out["total"]) > ml or int(out["n_unique"]) > ml)
        if not (grow_cap or grow_ml):
            break
        if grow_cap:
            cap, ecap = cap * 4, ecap * 4
        if grow_ml:
            ml *= 4
            _ml_hint_bump(ctx.get("index"), ml)
        n_retries += 1
        out = fetch_tree(ctx["run"](cap, ecap, ml))
    R, m, k, kb = ctx["R"], ctx["m"], ctx["k"], ctx["kb"]
    max_locate = ml
    # verified windows with no occurrence <= k are the analogue of the
    # reference's aborted in-text verifications (src/indexhelpers.cpp:547-571
    # InTextVerificationTask::doTask finding no cluster center <= maxED)
    aborted = int((out["valid"] & (out["final_rows"].min(axis=1) > k)).sum())
    stats = dict(
        total_candidates=int(out["total"]),
        overflow=int(out["overflow"]),
        nodes_visited=int(out["nodes_visited"]),
        itv_started=int(out["itv_started"]),
        searches_started=int(out["searches_started"]),
        aborted_in_text=aborted,
        retries=n_retries,
        locate_truncated=bool(out["total"] > max_locate)
        or bool(out["n_unique"] > max_locate),
    )

    occs = _extract_occurrences(out, R, m, k, kb, ctx["redundancy_filter"])
    return occs, stats


@partial(jax.jit, static_argnames=("max_locate",))
def _exact_device(index, batch, max_locate):
    """k=0 device step: backward exact match + two-phase expand + locate."""
    ranges = extend.exact_match(index, batch)
    rows, cand, valid, total = stage_expand(
        ranges[:, 0], ranges[:, 1], max_locate)
    pos = locate.locate_rows(index, rows)
    return pos, cand, valid, total


def _match_exact_finish(ec):
    """Fetch + retry + host-side assembly of a dispatched k=0 pass (the
    range expansion runs on device via stage_expand — a single exact read
    with 1e5 occurrences must not stall the host in a Python loop)."""
    index, batch, R = ec["index"], ec["batch"], ec["R"]
    ml = ec["max_locate"]
    m = batch.shape[1]
    pos, cand, valid, total = fetch_tree(ec["out"])
    tries = 0
    while ec["auto_locate"] and int(total) > ml and tries < 3:
        ml *= 4
        _ml_hint_bump(index, ml)
        pos, cand, valid, total = fetch_tree(
            _exact_device(index, batch, int(ml)))
        tries += 1
    total = int(total)
    pos_v = pos[valid].astype(np.int64)
    cand_v = cand[valid].astype(np.int64)
    read_id, strand = cand_v % R, cand_v // R
    order = np.lexsort((pos_v, strand, read_id))
    occs = OccArray(read_id[order], strand[order], pos_v[order],
                    pos_v[order] + m, np.zeros(order.size, np.int64))
    stats = dict(total_candidates=total, overflow=0, nodes_visited=0,
                 locate_truncated=total > ml, retries=tries)
    return occs, stats


@partial(jax.jit, static_argnames=("sched", "capacity"))
def _textless_device(index, batch, sched, tables, capacity):
    """Textless RLC device step: scheme run only — no locate/verify (both
    need O(n) structures); done lanes carry toehold samples in their
    range vectors (ops/bextend). track_arg compiles the matched-length
    shadow slots so edit begins come out exact."""
    res = executor.run_scheme(index, batch, sched, int(capacity),
                              None, None, None, 0, 0, 0, 0, tables=tables,
                              track_arg=True)
    return dict(ranges=res.ranges, rid=res.rid, sid=res.sid,
                ed_lb=res.ed_lb, done=res.done, overflow=res.overflow,
                nodes=res.nodes_visited, harvest=res.itv_count,
                searches=res.searches_started, arg_b=res.arg_b)


def _phi_eval(vals: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    j = np.searchsorted(xs, vals, side="right") - 1
    return ys[j] + (vals - xs[j])


def _phi_enumerate(seed, offs, widths, phi: np.ndarray):
    """Enumerate every row of each candidate interval from one in-range
    sample (value `seed`, 0-based interval offset `offs`, interval width
    `widths`): phi walks up (rows offs-1..0), phi-inverse walks down
    (rows offs+1..w-1). Vectorized across candidates; pass count = max
    chain length. Returns (cand_idx, values) flat arrays.

    The batched analogue of the reference's toehold + phi enumeration
    (src/bmove/bmove.cpp:503-547 collectTextPositions, plcp.h:59-130) —
    the known width + offset replace its PLCP stop condition."""
    xs, ys, xsi, ysi = (phi[:, 0].astype(np.int64),
                        phi[:, 1].astype(np.int64),
                        phi[:, 2].astype(np.int64),
                        phi[:, 3].astype(np.int64))
    n_c = len(seed)
    out_idx = [np.arange(n_c)]
    out_val = [seed.astype(np.int64)]
    # up
    live = np.nonzero(offs > 0)[0]
    vals = seed[live].astype(np.int64)
    rem = offs[live].copy()
    while live.size:
        vals = _phi_eval(vals, xs, ys)
        out_idx.append(live.copy())
        out_val.append(vals.copy())
        rem -= 1
        keep = rem > 0
        live, vals, rem = live[keep], vals[keep], rem[keep]
    # down
    live = np.nonzero(widths - 1 - offs > 0)[0]
    vals = seed[live].astype(np.int64)
    rem = (widths - 1 - offs)[live].copy()
    while live.size:
        vals = _phi_eval(vals, xsi, ysi)
        out_idx.append(live.copy())
        out_val.append(vals.copy())
        rem -= 1
        keep = rem > 0
        live, vals, rem = live[keep], vals[keep], rem[keep]
    return np.concatenate(out_idx), np.concatenate(out_val)


def _match_textless(index, host_arrays, batch_dev, R, k, kb, sched,
                    capacity, auto_capacity=True):
    """Textless RLC matching: frontier-only device pass + host phi locate.

    Occurrence distances are the search's exact extent distances (ed_lb of
    done lanes); begins are extent starts adjusted by the static back
    overshoot — the RLC no-CIGAR reporting mode (reference RLC default,
    src/parameters/alignparameters.cpp:131-160). Index bytes scale with
    runs r, not text length n."""
    tables = device_tables(sched)
    S = sched.num_searches
    cap = int(capacity)
    out = fetch_tree(_textless_device(index, batch_dev, sched, tables, cap))
    for _ in range(3):
        if not (auto_capacity and int(out["overflow"]) > 0):
            break
        cap *= 4
        out = fetch_tree(
            _textless_device(index, batch_dev, sched, tables, cap))

    sel = np.asarray(out["done"])
    ranges = np.asarray(out["ranges"])[sel]
    rid = np.asarray(out["rid"])[sel].astype(np.int64)
    sid = np.asarray(out["sid"])[sel].astype(np.int64)
    ed = np.asarray(out["ed_lb"])[sel].astype(np.int64)
    arg_b = np.asarray(out["arg_b"])[sel].astype(np.int64)
    stats = dict(
        total_candidates=0, overflow=int(out["overflow"]),
        nodes_visited=int(out["nodes"]),
        itv_started=0, searches_started=int(out["searches"]),
        # harvest rows carry no toehold; without text they cannot be
        # located (text-boundary deaths only) — counted, not reported
        aborted_in_text=int(out["harvest"]),
        locate_truncated=False,
    )
    if not sel.any():
        return OccArray.empty(), stats

    n = index.n
    flag = ranges[:, 10].astype(np.int64)
    lo = np.where(flag == 0, ranges[:, 0], ranges[:, 2]).astype(np.int64)
    hi = np.where(flag == 0, ranges[:, 1], ranges[:, 3]).astype(np.int64)
    w = hi - lo
    tv = ranges[:, 8].astype(np.int64)
    toff = ranges[:, 9].astype(np.int64)
    # static per-search extent length; the begin correction is the ACTUAL
    # back overshoot consumed, recovered per candidate from the tracked
    # matched-length witness (arg_b = back depth mod 64 at the final back
    # window's minimum) — exact begins, matching the reference's
    # matchedStr-length reporting (src/indexinterface.h:294-304). Lanes
    # whose back side is pure-exact (no band window, arg_b = -1) have
    # zero overshoot by construction.
    active = np.asarray(sched.active)
    ex_pos = np.asarray(sched.ex_pos)
    t_total = (ex_pos >= 0).sum(axis=1) + active.sum(axis=1)   # (S,)
    t_back_s = np.asarray(sched.t_back, dtype=np.int64)

    # enumerate each side's interval with its own phi tables
    parts = []
    for f, phi in ((0, host_arrays.phi_fwd), (1, host_arrays.phi_rev)):
        m_ = flag == f
        if not m_.any():
            continue
        seed = tv[m_] if f == 0 else (n - 1 - tv[m_])
        ci, vals = _phi_enumerate(seed, toff[m_], w[m_], phi)
        src = np.nonzero(m_)[0][ci]
        if f == 1:
            # rev SA value -> fwd extent start (extent text length is the
            # static extension count of the search)
            ends = n - 1 - vals
            vals = ends - (t_total[sid[src]] - 1)
        parts.append((src, vals))
    src = np.concatenate([p[0] for p in parts])
    starts = np.concatenate([p[1] for p in parts])
    stats["total_candidates"] = int(len(src))

    corr = (t_back_s[sid[src]] - arg_b[src]) & 63
    corr = np.where(arg_b[src] < 0, 0, corr)
    begin = starts + corr
    begin = np.clip(begin, 0, n - 1)
    read = rid[src] % R
    strand = rid[src] // R
    dist = ed[src]
    m_read = int(batch_dev.shape[1])
    # dedup + redundancy collapse: same (read, strand) within +-kb keeps
    # the lowest distance (the with-text path resolves these via verify
    # windows; without text the extent estimates stand in)
    order = np.lexsort((dist, begin, strand, read))
    read, strand, begin, dist = (read[order], strand[order], begin[order],
                                 dist[order])
    keep = np.ones(len(read), dtype=bool)
    if len(read) > 1:
        same = (read[1:] == read[:-1]) & (strand[1:] == strand[:-1])
        near = begin[1:] - begin[:-1] <= max(2 * kb, 1) - 1
        # within a (read, strand) group begins ascend; a chain of near
        # rows collapses to its first (lowest-begin, then lowest-dist)
        drop = same & near
        keep[1:] = ~drop
    read, strand, begin, dist = (read[keep], strand[keep], begin[keep],
                                 dist[keep])
    occs = OccArray(read, strand, begin, begin + m_read, dist)
    return occs, stats


def _extract_occurrences(out, R, m, k, kb, redundancy_filter=True) -> OccArray:
    """Final-row cluster centers -> dedup'd occurrences (array-native).

    Mirrors the reference's cluster-center reporting + unique filter
    (src/indexhelpers.cpp:276-382 cluster centers;
    src/indexinterface.cpp:1373-1491 getUniqueTextOccurrences).
    """
    valid = np.asarray(out["valid"])
    rows = np.asarray(out["final_rows"])
    # vectorized local-minimum (cluster-center) detection over all final
    # rows at once: leftmost-of-plateau, value <= k
    pad = np.full((rows.shape[0], 1), 127, rows.dtype)
    left = np.concatenate([pad, rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], pad], axis=1)
    is_min = (rows <= k) & (rows <= left) & (rows <= right)
    is_min[:, 1:] &= rows[:, 1:] != left[:, 1:]   # plateau: keep leftmost
    is_min &= valid[:, None]
    ii, aa = np.nonzero(is_min)
    if not ii.size:
        return OccArray.empty()
    rid_all = np.asarray(out["rid"])[ii].astype(np.int64)
    end_all = signed_positions(out["win_start"])[ii] + m + (aa - kb)
    ed_all = rows[ii, aa].astype(np.int64)
    # min distance per (rid, end)
    order = np.lexsort((ed_all, end_all, rid_all))
    rid_s, end_s, ed_s = rid_all[order], end_all[order], ed_all[order]
    first = np.empty(order.size, bool)
    first[0] = True
    first[1:] = (rid_s[1:] != rid_s[:-1]) | (end_s[1:] != end_s[:-1])
    rid2, end2, ed2 = rid_s[first], end_s[first], ed_s[first]
    if redundancy_filter:
        rid2, end2, ed2 = _redundancy_filter_arr(rid2, end2, ed2, k)
    # final order: (read_id, strand, end, begin); begin = end - m
    read_id, strand = rid2 % R, rid2 // R
    o2 = np.lexsort((end2, strand, read_id))
    return OccArray(read_id[o2], strand[o2], end2[o2] - m, end2[o2],
                    ed2[o2])


def apply_boundary_trim(
    occs: OccArray,
    reads_codes: np.ndarray,
    arrays,
    kb: int,
    k: int,
) -> OccArray:
    """Cross-boundary occurrence trimming + re-verification.

    The index text concatenates the input sequences with no separators, so
    an alignment can straddle two chromosomes. Mirrors the reference's
    findSeqName (src/indexinterface.cpp:799-897): refine the begin of any
    suspect occurrence, and if [begin, end) really spans a boundary, trim
    to the side within ``k`` (largestStratum) of the boundary, re-verify
    the full read inside the clipped slice
    (inTextVerificationOneString, :850-867), and re-bin its distance —
    or drop it. Hamming/exact occurrences that span are dropped
    (:829-832 disallows trimming for Hamming).

    reads_codes: (R, m) original reads (strand-1 occurrences re-verify
    against the reverse complement). Suspect detection is vectorized; the
    per-occurrence host DP only runs for the rare boundary-window cases.
    """
    starts = arrays.seq_starts
    if len(starts) <= 2 or not len(occs):
        return occs
    from columba_jax.core import alphabet
    from columba_jax.index.build import unpack_window
    from columba_jax.io import sam

    m = reads_codes.shape[1]
    ends = occs.end
    w_lo = np.maximum(ends - m - kb, 0)
    i_lo = np.searchsorted(starts, w_lo, side="right")
    i_hi = np.searchsorted(starts, ends - 1, side="right")
    suspect = i_lo != i_hi
    if not suspect.any():
        return occs

    # keep arrays; only the (rare) suspects pay a per-occurrence host DP
    keep = ~suspect
    nb = occs.begin.copy()
    ne = occs.end.copy()
    nd = occs.distance.copy()
    for j in np.nonzero(suspect)[0]:
        o_rid, o_str = int(occs.read_id[j]), int(occs.strand[j])
        o_end = int(occs.end[j])
        pat = (reads_codes[o_rid] if o_str == 0
               else alphabet.revcomp(reads_codes[o_rid]))
        lo0 = int(w_lo[j])
        window = unpack_window(arrays.text, lo0, o_end)
        begin_rel, _, _ = sam.traceback(pat, window, o_end - lo0, kb)
        begin = lo0 + begin_rel
        idx = int(np.searchsorted(starts, begin, side="right") - 1)
        if o_end <= starts[idx + 1]:
            keep[j] = True  # the window crossed, the alignment did not
            continue
        if kb == 0:
            continue  # hamming/exact: no trimming allowed -> drop
        if starts[idx + 1] - begin <= k:
            idx += 1
            lo, hi = int(starts[idx]), int(min(o_end, starts[idx + 1]))
        elif o_end - starts[idx + 1] <= k:
            lo, hi = begin, int(starts[idx + 1])
        else:
            continue
        res = sam.best_in_window(pat, unpack_window(arrays.text, lo, hi), k)
        if res is None:
            continue
        b, e, ed, _ = res
        keep[j] = True
        nb[j], ne[j], nd[j] = lo + b, lo + e, ed
    return OccArray(occs.read_id[keep], occs.strand[keep], nb[keep],
                    ne[keep], nd[keep])


def _redundancy_filter_arr(rid, end, ed, k: int):
    """Among occurrences of the same read/strand with nearby ends, keep the
    best (reference: src/indexinterface.cpp:1451-1485, window 2*maxED).

    Inputs must be sorted by (rid, end, ed); rid encodes (read, strand).
    Clusters chain consecutive ends within max(1, 2k)-1; the kept entry per
    cluster is min by (distance, end). Returns filtered (rid, end, ed)."""
    n = rid.shape[0]
    if n == 0:
        return rid, end, ed
    thresh = max(1, 2 * k) - 1
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = (rid[1:] != rid[:-1]) | ((end[1:] - end[:-1]) > thresh)
    cid = np.cumsum(new) - 1
    order = np.lexsort((end, ed, cid))
    firstc = np.empty(n, bool)
    firstc[0] = True
    firstc[1:] = cid[order][1:] != cid[order][:-1]
    keep = np.sort(order[firstc])
    return rid[keep], end[keep], ed[keep]
