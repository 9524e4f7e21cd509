"""Lockstep frontier executor for search schemes.

Batched replacement of the reference's recursive DFS engine
(reference: src/indexinterface.cpp:377-527 ``recApproxMatchEdit``,
:1211-1304 ``recApproxMatchHamming``): a fixed-capacity frontier of
SA-interval nodes advances one text character per lockstep step, driven by
the static tables of search/schedule.py.

Per step, vectorized over all lanes:
  1. bidirectional extension of every node by all 4 characters
     (ops/extend.py — two occ gathers per node serve all 4 children);
  2. banded-DP row update of the active side's band (min-plus over the
     band, unrolled — the role of the reference's bit-parallel
     ``computeRow``, src/bitparallelmatrix.h:352-415);
  3. colMin accumulation (exact per-extent column minima — replaces the
     reference's cluster machinery);
  4. pruning by the scheme's U bound + empty-range cull;
  5. compaction into the fixed-capacity frontier via cumsum + scatter-drop.

The whole loop is one lax.scan -> a single XLA program; no host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import extend
from columba_jax.search.schedule import INF, Schedule

# Ghost-lane id encoding (boundary-harvest deaths kept inert in the
# frontier): bit 31 flags a ghost, bits 21-30 stash the death-step back
# depth, bits 0-20 the lane id (caps R * S at 2^21 lanes per batch).
GHOST_BIT = np.int32(-2147483648)  # 1 << 31 as int32
GHOST_IDM = (1 << 21) - 1


@dataclass(frozen=True)
class FrontierResult:
    """Final frontier after a scheme run (candidate hits where done)."""

    ranges: jax.Array     # (C, 4) uint32 SA range pairs
    rid: jax.Array        # (C,) read row
    sid: jax.Array        # (C,) search id
    ed_lb: jax.Array      # (C,) colMin_back + colMin_fwd (exact-extent ED lower bound)
    done: jax.Array       # (C,) bool: completed candidate
    overflow: jax.Array   # () int32: lanes dropped by capacity (0 => lossless)
    nodes_visited: jax.Array  # () int32 total extensions (Counters analogue)
    # in-text verification crossover (switchpoint > 0): nodes whose range
    # narrowed to <= switchpoint left the frontier into this buffer
    # (reference: src/indexinterface.cpp:340-375 goToInTextVerificationEdit)
    itv: jax.Array        # (M, 4) uint32 rows [f_lo, f_hi, ids, back_depth]
    itv_count: jax.Array  # () int32 valid rows (clamped to M)
    searches_started: jax.Array = 0  # () int32 searches entering the band
                                     # phase (reference SEARCH_STARTED)
    arg_b: jax.Array = 0  # (C,) int8 back depth (mod 64) of the final back
                          # window's minimum (track_arg runs; -1 = no
                          # back window) — textless exact begins
    live_hist: jax.Array = 0  # (T,) int32 live lanes per band step
                              # (COLUMBA_JAX_STEP_STATS profiling builds)


jax.tree_util.register_dataclass(
    FrontierResult,
    data_fields=["ranges", "rid", "sid", "ed_lb", "done", "overflow",
                 "nodes_visited", "itv", "itv_count", "searches_started",
                 "arg_b", "live_hist"],
    meta_fields=[],
)


def host_tables(sched: Schedule) -> dict:
    """Schedule tables as NUMPY arrays, stacked for the step loop.

    Per-(search, step) scalars pack into one int32 meta word (bit 0: active;
    bit 1: side; bits 2-5: cacc register; bits 6-9: cfro register; bits
    10-17: ub; bits 18-29: back depth) plus the three packed colMin
    register-op words each of cops/cini (7-bit slots, 4 per word), stacked
    as one (T, S, 7) array so the loop body does a single dynamic row slice
    per step.

    These reach run_scheme as jit ARGUMENTS (pipeline device-puts and
    caches them per schedule), never as in-trace constants, so a new
    schedule reuses the compiled program shape. The (S,)-shaped
    per-search tables (u_last, t_back, pivot, final_reg) stay off this dict
    entirely — consumers unroll them into literal-operand where-selects
    (whether the packing pays on the GPU: ROADMAP C2).
    """
    meta = (
        sched.active.astype(np.int32)
        | (sched.side.astype(np.int32) << 1)
        | (sched.cacc.astype(np.int32) << 2)
        | (sched.cfro.astype(np.int32) << 6)
        | (sched.ub.astype(np.int32) << 10)
        | (sched.db.astype(np.int32) << 18)   # back depth, for in-text est
    )
    mrow = np.stack(
        [meta.T] + [sched.cops[:, :, w].T for w in range(3)]
        + [sched.cini[:, :, w].T for w in range(3)], axis=-1)
    # band cell codes with validity folded in: 0 = read pchars, -1 = no
    # diag transition, -2 = cell outside the pattern
    code = np.where(~sched.cvalid, np.int8(-2),
                    np.where(~sched.mvalid, np.int8(-1), np.int8(0)))
    return dict(
        mrow=np.ascontiguousarray(mrow),                   # (T, S, 5)
        ex_pos=np.ascontiguousarray(sched.ex_pos.T),       # (E, S)
        ex_dir=np.ascontiguousarray(sched.ex_dir.T),       # (E, S)
        db_ex=np.ascontiguousarray(sched.db_ex.T),         # (E, S)
        db_exact=sched.db_exact.astype(np.int32),          # (S,)
        kmer_start=sched.kmer_start.astype(np.int32),      # (S,)
        band_init=sched.band_init.astype(np.int8),         # (S, 2, BW)
        colmin_init=sched.colmin_init.astype(np.int8),     # (S, 2, W)
        posw=sched.posw.astype(np.int32),                  # (S, T, BW)
        code=code.astype(np.int8),                         # (S, T, BW)
    )


def select_by(key: jax.Array, values) -> jax.Array:
    """values[key] for a tiny static table, as unrolled where-selects.

    values: python sequence of literals OR a traced (S, ...) array with
    small static S: S broadcast-selects fuse into the consumer instead of
    issuing a gather (ROADMAP C2).
    """
    out = jnp.broadcast_to(jnp.asarray(values[0]), key.shape)
    for s in range(1, len(values)):
        out = jnp.where(key == s, jnp.asarray(values[s]), out)
    return out


def _band_row_update(prev, pchars, bw):
    """One banded-DP row for all 4 extension chars.

    prev: (C, BW) previous row (int8); pchars: (C, BW) int8 per-cell codes
    with validity folded in: 0..4 = pattern char (4=N, mismatches all),
    -1 = no diag transition (j==0), -2 = cell outside the pattern (INF).
    Returns (C, 4, BW) new rows (char-major).
    """
    up = jnp.concatenate(
        [prev[:, 1:], jnp.full((prev.shape[0], 1), INF, dtype=prev.dtype)], axis=1
    )
    one = jnp.ones((), prev.dtype)
    cval = pchars >= -1
    rows = []
    for c in range(4):
        mis = jnp.where(pchars == c, 0, jnp.where(pchars >= 0, 1, INF)).astype(prev.dtype)
        nl = jnp.minimum(prev + mis, up + one)
        # left-to-right deletion scan: D[o] = min(D[o-1] + 1, nl[o])
        d = nl[:, 0:1]
        cols = [d]
        for o in range(1, bw):
            d = jnp.minimum(nl[:, o:o + 1], d + one)
            cols.append(d)
        row = jnp.concatenate(cols, axis=1) if bw > 1 else nl
        # saturate at INF so int8 cells cannot overflow over long schedules
        # (k=13 runs 120+ rows); saturation only loosens bounds and every
        # candidate is re-verified in-text.
        rows.append(jnp.where(cval, jnp.minimum(row, jnp.asarray(INF, prev.dtype)),
                              jnp.asarray(INF, prev.dtype)))
    return jnp.stack(rows, axis=1)



def _pack_state(ranges, ids, band, colmin, bw, W):
    """Pack one frontier lane's state into uint32 words.

    Layout: w0..w3 ranges, w4 ids, then 2*bw band bytes + 2*W colmin bytes
    little-endian-packed 4 per word. One contiguous row per lane makes the
    per-step compaction a single row gather.
    """
    lead = ranges.shape[:-1]
    rw = ranges.shape[-1]
    nb = 2 * bw + 2 * W
    nw = (nb + 3) // 4
    by = jnp.concatenate(
        [band.reshape(*lead, 2 * bw), colmin.reshape(*lead, 2 * W)], axis=-1
    ).astype(jnp.uint8)
    pad = nw * 4 - nb
    if pad:
        by = jnp.concatenate(
            [by, jnp.zeros((*lead, pad), jnp.uint8)], axis=-1)
    # bitcast 4 bytes -> 1 word (no shift/sum arithmetic: the byte packing
    # is pure layout; its inverse in _unpack_state bitcasts back)
    import os as _os
    if _os.environ.get("COLUMBA_JAX_SHIFT_PACK"):
        byw = by.astype(jnp.uint32).reshape(*lead, nw, 4)
        shifts = (8 * jnp.arange(4, dtype=jnp.uint32))
        words = jnp.sum(byw << shifts, axis=-1, dtype=jnp.uint32)
    else:
        words = jax.lax.bitcast_convert_type(
            by.reshape(*lead, nw, 4), jnp.uint32)
    out = jnp.concatenate(
        [ranges.astype(jnp.uint32), ids[..., None].astype(jnp.uint32), words],
        axis=-1,
    )
    # pad rows to an aligned power-of-two width: the per-step compaction is
    # a row gather of this state, and aligned rows keep each gathered row
    # whole (tools/gather_bench.py measures row widths; ROADMAP C1)
    total = out.shape[-1]
    padded = 1 << (total - 1).bit_length()
    if total < padded:
        out = jnp.concatenate(
            [out, jnp.zeros((*lead, padded - total), jnp.uint32)], axis=-1)
    return out


def _unpack_state(packed, bw, W, rw=4):
    lead = packed.shape[:-1]
    ranges = packed[..., :rw]  # uint32 (rows/positions; run hints bitcast)
    ids = packed[..., rw].astype(jnp.int32)
    nb = 2 * bw + 2 * W
    nw = (nb + 3) // 4
    words = packed[..., rw + 1:rw + 1 + nw]               # (..., nw) uint32
    import os as _os
    if _os.environ.get("COLUMBA_JAX_SHIFT_PACK"):
        shifts = (8 * jnp.arange(4, dtype=jnp.uint32))
        by = ((words[..., None] >> shifts) & jnp.uint32(0xFF)).astype(
            jnp.int8)
    else:
        by = jax.lax.bitcast_convert_type(words, jnp.uint8).astype(jnp.int8)
    by = by.reshape(*lead, nw * 4)[..., :nb]
    band = by[..., :2 * bw].reshape(*lead, 2, bw)
    colmin = by[..., 2 * bw:].reshape(*lead, 2, W)
    return ranges, ids, band, colmin


def run_scheme(
    index: FMIndex,
    reads: jax.Array,
    sched: Schedule,
    capacity: int,
    kmer_table: jax.Array | None = None,
    search_mask: jax.Array | None = None,
    dyn: dict | None = None,
    switchpoint: int = 0,
    itv_cap: int = 0,
    split_step: int = 0,
    capacity2: int = 0,
    itv_min_depth: int = 20,
    tables: dict | None = None,
    ex_split: int = 0,
    ex_cap: int = 0,
    track_arg: bool = False,
) -> FrontierResult:
    """Execute one compiled scheme over a read batch.

    reads: (R, m) int32 codes (strands are separate rows).
    capacity: frontier size C (must be >= R * num_searches).
    kmer_table: optional (4^K, 4) seed table (index.kmer) matching the
    schedule's kmer_k; seeds the exact-prefix ranges with one gather.
    ex_split/ex_cap: two-stage exact loop — after `ex_split` steps the
    surviving lanes are compacted into `ex_cap` lanes (overflow-counted)
    for the remaining steps. By then nearly every lane has died (errors)
    or drained to the in-text buffer (narrow clean segments), so the tail
    of the exact prefix runs at a fraction of the full lane count.
    """
    R, m = reads.shape
    S = sched.num_searches
    C = int(capacity)
    bw = sched.bw
    if R * S > GHOST_IDM + 1:
        raise ValueError(
            f"batch of {R} rows x {S} searches exceeds the 2^21 lane-id "
            "space (ghost encoding); lower the batch size")
    if dyn is None:
        if tables is None:  # convenience for direct/test callers
            tables = {kk: jnp.asarray(v)
                      for kk, v in host_tables(sched).items()}
        T = sched.t_max
        E = sched.e_max
        W = int(getattr(sched, "W", 1))
    else:
        # parametric (per-read) schedule: see search/dynschedule.py
        # (single colMin register: dynamic partitioning clamps every part
        # to length > 2k, so windows never overlap)
        T = dyn["meta"].shape[1]
        E = dyn["ex_pos"].shape[1]
        W = 1

    # track_arg (textless exact begins): each colMin register carries a
    # shadow int8 slot holding the back depth (mod 64) at which its value
    # last strictly decreased — the batched analogue of the reference's
    # matchedStr length per DFS leaf (src/indexinterface.h:294-304). The
    # shadow slots ride in the colmin byte region at [W, 2W) per side, so
    # the packing layout machinery is untouched; compiled only into the
    # textless variant (default paths pay nothing).
    if track_arg and dyn is not None:
        raise NotImplementedError("track_arg with parametric schedules")
    Wp = 2 * W if track_arg else W

    rw = index.range_width if hasattr(index, "range_width") else 4
    if rw != 4 and kmer_table is not None:
        raise NotImplementedError(
            "k-mer seed table is 4-wide (no run hints); pass kmer_table=None "
            "for the RLC back-end")

    # ---------------- exact prefix ----------------
    rid0, sid0 = jnp.meshgrid(
        jnp.arange(R, dtype=jnp.int32), jnp.arange(S, dtype=jnp.int32),
        indexing="ij",
    )
    rid0, sid0 = rid0.reshape(-1), sid0.reshape(-1)
    if dyn is not None:
        ranges0 = index.full_range((R * S,))
    elif sched.kmer_k > 0 and kmer_table is not None:
        from columba_jax.index import kmer as kmer_mod

        # per-search seed windows are STATIC column ranges of the read
        # (kmer_start is compile-time): slice, pack, and gather per search
        # — no element gather over (L, K) window positions
        Kk = sched.kmer_k
        full1 = index.full_range((R,))
        col_ranges = []
        for s in range(S):
            ks = int(sched.kmer_start[s])
            if ks < 0:
                col_ranges.append(full1)
            else:
                col_ranges.append(
                    kmer_mod.lookup(kmer_table, reads[:, ks:ks + Kk]))
        ranges0 = jnp.stack(col_ranges, axis=1).reshape(R * S, 4)
    else:
        assert sched.kmer_k == 0, "schedule compiled with kmer seeding but no table given"
        ranges0 = index.full_range((R * S,))

    if search_mask is not None:
        # dynamic scheme selection: only the chosen scheme's searches live
        ranges0 = jnp.where(search_mask.reshape(-1)[:, None], ranges0, 0)

    # the in-text buffer also receives BOUNDARY HARVEST rows (lanes whose
    # every extension dies because the text ends — their already-completed
    # occurrences must still reach locate/verify), so it exists even with
    # the crossover off
    M = max(int(itv_cap), 4096)
    itv_buf0 = jnp.zeros((M + 1, 4), jnp.uint32)
    itv_cnt0 = jnp.zeros((), jnp.int32)
    L = R * S
    ids0 = rid0 * S + sid0
    # zero dead lanes so liveness stays implicit through compaction
    ranges0 = jnp.where((ranges0[:, 1] > ranges0[:, 0])[:, None], ranges0, 0)

    kmer_eff = sched.kmer_k if (dyn is None and kmer_table is not None) else 0

    def drain(ranges, ids, dbt, itv_buf, itv_cnt, allow=True):
        """Move lanes with 0 < width <= switchpoint into the in-text buffer
        (the reference skips searches whose start range is narrow the same
        way, src/searchstrategy.cpp:1181-1254 + exactMatchesOutput's early
        crossover src/indexinterface.cpp:947-1014)."""
        width = ranges[:, 1] - ranges[:, 0]
        narrow = (width > 0) & (width <= switchpoint) & allow
        npos = jnp.cumsum(narrow.astype(jnp.int32)) - 1
        dest = jnp.where(narrow, jnp.minimum(itv_cnt + npos, M), M)
        rows = jnp.stack([ranges[:, 0], ranges[:, 1],
                          ids.astype(jnp.uint32),
                          dbt.astype(jnp.uint32)], axis=1)
        itv_buf = itv_buf.at[dest].set(rows, mode="drop")
        itv_cnt = jnp.minimum(itv_cnt + npos[-1] + 1, M)
        return jnp.where(narrow[:, None], 0, ranges), itv_buf, itv_cnt

    # ---------------- exact prefix ----------------
    # A lockstep while_loop over exact steps with early exit once every
    # lane has died or crossed over. Lanes are NOT compacted inside the
    # loop — the loop body costs L lanes per step regardless, so per-step
    # compaction (a scatter + full-state gather) would be pure overhead,
    # and keeping lanes in place makes every table lookup a static
    # precomputed (E, L) row slice. Crossover drains land in a lane-slot
    # buffer (a where-select, no scatter); ONE compaction after the loop
    # moves them into the in-text buffer.
    overflow_ex = jnp.zeros((), jnp.int32)
    if E > 0:
        if dyn is None:
            # lanes are rid-major (sid = lane % S): per-lane tables are
            # tiles of the (E, S) args — a broadcast, never a gather
            ex_pos_l = jnp.tile(tables["ex_pos"], (1, R))     # (E, L)
            ex_dir_l = jnp.tile(tables["ex_dir"], (1, R))
            db_ex_l = jnp.tile(tables["db_ex"], (1, R))
            # pattern chars for every (step, lane), built up front so the
            # loop body row-slices instead of element-gathering per step.
            # sched.ex_pos is compile-time and each search's exact prefix
            # is a few CONTIGUOUS runs of read positions, so the whole
            # (E, L) table assembles from static slices (+flips for
            # backward runs) — no gather at all
            exp_np = np.asarray(sched.ex_pos)                 # (S, E)
            per_search = []
            for s in range(S):
                segs = []
                e = 0
                while e < E:
                    p = int(exp_np[s, e])
                    if p < 0:
                        e2 = e
                        while e2 < E and int(exp_np[s, e2]) < 0:
                            e2 += 1
                        segs.append(jnp.zeros((e2 - e, R), reads.dtype))
                        e = e2
                        continue
                    e2 = e + 1
                    step_dir = 0
                    while e2 < E:
                        q = int(exp_np[s, e2])
                        d = q - int(exp_np[s, e2 - 1])
                        if q < 0 or d not in (1, -1) or (
                                step_dir and d != step_dir):
                            break
                        step_dir = d
                        e2 += 1
                    lo = min(int(exp_np[s, e]), int(exp_np[s, e2 - 1]))
                    hi = max(int(exp_np[s, e]), int(exp_np[s, e2 - 1]))
                    run = reads[:, lo:hi + 1].T               # (len, R)
                    if int(exp_np[s, e]) > int(exp_np[s, e2 - 1]):
                        run = jnp.flip(run, axis=0)
                    segs.append(run)
                    e = e2
                per_search.append(
                    jnp.concatenate(segs, axis=0) if len(segs) > 1
                    else segs[0])                             # (E, R)
            ex_chars = jnp.stack(per_search, axis=2).reshape(
                E, L).astype(jnp.int32)                       # (E, L)
        else:
            ex_pos_l = dyn["ex_pos"].T                        # (E, L)
            ex_dir_l = dyn["ex_dir"].T
            db_ex_l = dyn["db_ex_steps"].T
            ex_chars = reads[
                rid0[:, None], jnp.clip(dyn["ex_pos"], 0, m - 1)
            ].T.astype(jnp.int32)                             # (E, L)
        # gate the crossover on matched depth: a segment shorter than
        # ~20 chars is not specific (4^20 >> genome), so draining early
        # floods locate/verify with junk windows
        gate_t = max(0, itv_min_depth - kmer_eff - 1)
        drain_rows0 = jnp.zeros((L, 4), jnp.uint32)

        def make_ex(pos_tab, dir_tab, db_tab, chars_tab, ids_vec, t_off,
                    t_hi):
            def ex_cond(c):
                t, ranges = c[0], c[1]
                return (t < t_hi) & jnp.any(ranges[:, 1] > ranges[:, 0])

            def ex_body(c):
                t, ranges, drows = c
                alive = ranges[:, 1] > ranges[:, 0]
                pos = pos_tab[t]
                drc = dir_tab[t]
                act = (pos >= 0) & alive
                chars = chars_tab[t]
                new = extend.extend_char(
                    index, jnp.where(act[:, None], ranges, 0), chars, drc)
                new = jnp.where(act[:, None], new, ranges)
                new = jnp.where((new[:, 1] > new[:, 0])[:, None], new, 0)
                if switchpoint > 0:
                    width = new[:, 1] - new[:, 0]
                    narrow = ((width > 0) & (width <= switchpoint)
                              & (t + t_off >= gate_t))
                    row = jnp.stack(
                        [new[:, 0], new[:, 1], ids_vec.astype(jnp.uint32),
                         db_tab[t].astype(jnp.uint32)], axis=1)
                    drows = jnp.where(narrow[:, None], row, drows)
                    new = jnp.where(narrow[:, None], 0, new)
                return t + 1, new, drows

            return ex_cond, ex_body


        if 0 < ex_split < E and 0 < ex_cap < L:
            # stage 1 at full lane count
            c1, b1 = make_ex(ex_pos_l, ex_dir_l, db_ex_l, ex_chars, ids0,
                             0, ex_split)
            _, ranges0, drain_rows0 = jax.lax.while_loop(
                c1, b1, (jnp.zeros((), jnp.int32), ranges0, drain_rows0))

            # compact survivors into ex_cap lanes (4-byte src scatter + row
            # gathers; all per-lane step tables re-gathered once, not per
            # step)
            EC = int(ex_cap)
            alive1 = ranges0[:, 1] > ranges0[:, 0]
            pos1 = jnp.cumsum(alive1.astype(jnp.int32)) - 1
            overflow_ex = jnp.maximum(pos1[-1] + 1 - EC, 0)
            dest1 = jnp.where(alive1, jnp.minimum(pos1, EC), EC)
            src1 = jnp.full((EC + 1,), L, jnp.int32)
            src1 = src1.at[dest1].set(jnp.arange(L, dtype=jnp.int32),
                                      mode="drop")[:EC]
            live1 = src1 < L
            srcc1 = jnp.where(live1, src1, 0)
            r2 = jnp.where(live1[:, None], ranges0[srcc1], 0)
            ids2 = ids0[srcc1]
            chars2 = ex_chars[ex_split:, srcc1]
            pos2t = ex_pos_l[ex_split:, srcc1]
            dir2t = ex_dir_l[ex_split:, srcc1]
            db2t = db_ex_l[ex_split:, srcc1]
            drows2 = jnp.zeros((EC, 4), jnp.uint32)

            c2, b2 = make_ex(pos2t, dir2t, db2t, chars2, ids2, ex_split,
                             E - ex_split)
            _, r2, drows2 = jax.lax.while_loop(
                c2, b2, (jnp.zeros((), jnp.int32), r2, drows2))

            # scatter stage-2 state back into full-L lane layout (surviving
            # stage-1 lanes had no drain row, so the drain scatter cannot
            # clobber one)
            back = jnp.where(live1, srcc1, L)
            ranges0 = jnp.zeros((L, 4), jnp.uint32).at[back].set(
                r2, mode="drop")
            drain_rows0 = drain_rows0.at[back].set(drows2, mode="drop")
        else:
            c1, b1 = make_ex(ex_pos_l, ex_dir_l, db_ex_l, ex_chars, ids0,
                             0, E)
            _, ranges0, drain_rows0 = jax.lax.while_loop(
                c1, b1, (jnp.zeros((), jnp.int32), ranges0, drain_rows0))

        if switchpoint > 0:
            dvalid = drain_rows0[:, 1] > drain_rows0[:, 0]
            npos = jnp.cumsum(dvalid.astype(jnp.int32)) - 1
            dest = jnp.where(dvalid, jnp.minimum(npos, M), M)
            itv_buf0 = itv_buf0.at[dest].set(drain_rows0, mode="drop")
            itv_cnt0 = jnp.minimum(npos[-1] + 1, M)

    # ---------------- frontier init ----------------
    # Compact the R*S initial nodes into the C-lane frontier, dropping the
    # nodes whose exact prefix already died (for errorful reads most
    # searches die here, so C may be chosen well below R*S).
    # State compactness matters (the per-step compaction moves the whole
    # state): bands/colmin are int8 and rid/sid pack into one int32;
    # liveness is implicit (empty range = dead).
    if switchpoint > 0:
        db_ex0 = (jnp.tile(tables["db_exact"], R) if dyn is None
                  else dyn["db_exact"][ids0])
        ranges0, itv_buf0, itv_cnt0 = drain(
            ranges0, ids0, db_ex0, itv_buf0, itv_cnt0)

    alive0 = ranges0[:, 1] > ranges0[:, 0]
    pos0 = jnp.cumsum(alive0.astype(jnp.int32)) - 1
    dest0 = jnp.where(alive0, jnp.where(pos0 >= C, C, pos0), C)
    n_alive0 = pos0[-1] + 1
    overflow0 = jnp.maximum(n_alive0 - C, 0) + overflow_ex
    src0 = jnp.full((C + 1,), R * S, jnp.int32)
    src0 = src0.at[dest0].set(jnp.arange(R * S, dtype=jnp.int32),
                              mode="drop")[:C]
    live0 = src0 < R * S
    srcc0 = jnp.where(live0, src0, 0)

    def take0(val, fill):
        out = val[srcc0]
        shape = (C,) + (1,) * (out.ndim - 1)
        return jnp.where(live0.reshape(shape), out, jnp.asarray(fill, val.dtype))

    # lanes stay in R*S layout through the exact loop, so per-lane init
    # tables are positionally aligned
    if dyn is not None:
        band_init = dyn["band_init"]
        colmin_init = dyn["colmin_init"].reshape(L, 2, 1)
    else:
        band_init = jnp.tile(tables["band_init"], (R, 1, 1))
        colmin_init = jnp.tile(tables["colmin_init"], (R, 1, 1))
    if track_arg:
        colmin_init = jnp.concatenate(
            [colmin_init, jnp.zeros(colmin_init.shape[:-1] + (W,),
                                    colmin_init.dtype)], axis=-1)
    state = _pack_state(
        take0(ranges0, 0),
        take0(ids0, 0),
        take0(band_init, INF),
        take0(colmin_init, INF),
        bw, Wp,
    )
    visits0 = jnp.zeros((), jnp.int32)

    # Pattern-char windows for every (read, search, step), precomputed with
    # one vectorized gather and with cell validity folded in (-1 = no diag,
    # -2 = invalid cell); the scan then does one contiguous row gather per
    # lane instead of a 2D element gather plus two mask lookups per step.
    if dyn is not None:
        pchars_flat = dyn["pchars"]
        meta_flat = dyn["meta"].reshape(-1)                   # (R*S*T,)
    elif T > 0:
        posw_all = tables["posw"]                             # (S, T, BW)
        pchars_all = reads.astype(jnp.int8)[:, posw_all]      # (R, S, T, BW)
        code = tables["code"]                                 # (S, T, BW)
        pchars_all = jnp.where(code[None] == 0, pchars_all, code[None])
        pchars_flat = pchars_all.reshape(R * S * T, bw)

    # ---------------- lockstep band steps ----------------
    def make_step(C):
      def step(carry, xs):
        meta_row, t_idx = xs                      # (S, 5) packed scalars
        st, overflow, visits, itv_buf, itv_cnt, *dbg = carry
        ranges, ids, band, colmin = _unpack_state(st, bw, Wp, rw)
        # GHOST lanes (boundary-harvest deaths kept inert in place, see
        # below): bit 31 flags, bits 21-30 stash the death-step back
        # depth; bits 0-20 remain the lane id. Ghosts cost a frontier
        # slot (rare) instead of a per-step harvest scatter (measured
        # ~3.8 ms/step at C=131072, tools/profile_step2.py).
        ghost = ids < 0
        ids_c = ids & GHOST_IDM
        sid = ids_c % S
        alive = ranges[:, 1] > ranges[:, 0]
        if dyn is not None:
            meta = meta_flat[ids_c * T + t_idx]   # per-(read,search) scalars
            # translate the single-register dyn meta layout (bit 2: creset,
            # bits 3-8: colo+1, bits 9-16 ub, bits 17-28 db) into register-op
            # form (W == 1 for parametric schedules)
            colo_d = ((meta >> 3) & 63) - 1
            cops_w = [jnp.where(colo_d >= 0,
                                colo_d | (((meta >> 2) & 1) << 6), 63)]
            cini_w = [jnp.full_like(meta, 63)]
            cacc_l = jnp.where(colo_d >= 0, 0, 15)
            cfro_l = jnp.zeros_like(meta)
            ub = (meta >> 9) & 255
            dbv = (meta >> 17) & 4095
        else:
            # unrolled selects over the S searches; a (S, 5) gather by a
            # traced (C,) index would drop the whole step off the fast
            # codegen path
            meta = select_by(sid, meta_row[:, 0])
            cops_w = [select_by(sid, meta_row[:, 1]),
                      select_by(sid, meta_row[:, 2]),
                      select_by(sid, meta_row[:, 3])]
            cini_w = [select_by(sid, meta_row[:, 4]),
                      select_by(sid, meta_row[:, 5]),
                      select_by(sid, meta_row[:, 6])]
            cacc_l = (meta >> 2) & 15
            cfro_l = (meta >> 6) & 15
            ub = (meta >> 10) & 255
            dbv = (meta >> 18) & 4095
        act = ((meta & 1) == 1) & alive & ~ghost  # (C,)
        sd = (meta >> 1) & 1                      # (C,)
        visits = visits + jnp.sum(act.astype(jnp.int32)) * 4

        # 1) extension (all 4 chars); inactive lanes query position 0
        rng = jnp.where(act[:, None], ranges, 0)
        children = extend.extend_all(index, rng, sd)          # (C, 4ch, 4)

        # 2) band row update on the active side (side-indexed accesses are
        # where-selects, not fancy-index scatters/gathers).
        is_b = (sd == 0)
        prev = jnp.where(is_b[:, None], band[:, 0], band[:, 1])
        pchars = pchars_flat[ids_c * T + t_idx]               # (C, BW) int8
        newD = _band_row_update(prev, pchars, bw)             # (C, 4ch, BW) int8

        # 3) colMin registers (cell picks via unrolled selects, not
        # take_along_axis). Each of the W rotating registers accumulates
        # its window's cell; windows overlap when parts are shorter than
        # 2k+1 (schedule.py assigns registers by interval coloring).
        cm0, cm1 = colmin[:, 0], colmin[:, 1]                 # (C, W)
        cm_sd = jnp.where(is_b[:, None], cm0, cm1)            # (C, W)
        cm_other = jnp.where(is_b[:, None], cm1, cm0)         # (C, W)
        regs = []
        args_new = []
        if track_arg:
            dbv_mod = (dbv & 63).astype(jnp.int8)             # (C,)
        for w_ in range(W):
            op = (cops_w[w_ // 4] >> (7 * (w_ % 4))) & 127    # (C,)
            cell = op & 63
            rst = (op & 64) == 64
            ini = ((cini_w[w_ // 4] >> (7 * (w_ % 4))) & 127).astype(jnp.int8)
            base = jnp.where(rst, jnp.minimum(jnp.int8(INF), ini),
                             cm_sd[:, w_])
            acc = jnp.full((C, 4), INF, jnp.int8)
            for o_ in range(bw):
                acc = jnp.where((cell == o_)[:, None], newD[:, :, o_], acc)
            valid = (cell < 63)[:, None]
            regs.append(jnp.where(
                valid, jnp.minimum(base[:, None], acc), cm_sd[:, w_][:, None]))
            if track_arg:
                # shadow arg: reset rows restart the witness at the current
                # depth; strict decreases move it (ties keep the earliest —
                # the smallest matched back extent)
                prev_arg = jnp.where(rst, dbv_mod, cm_sd[:, W + w_])
                args_new.append(jnp.where(
                    valid & (acc < base[:, None]), dbv_mod[:, None],
                    prev_arg[:, None]))
        new_cm_sd = jnp.stack(regs + args_new, axis=2)        # (C, 4ch, Wp)

        # 4) prune. The CURRENT phase's window register participates in the
        # bound only while fresh (cacc = 7 outside the window); the other
        # side contributes its last COMPLETED window's register (cfro; 7 =
        # none completed yet => 0, the exact prefix's completion minimum).
        # Outside the window the rowMin bound alone is lossless: a covered
        # occurrence's alignment path keeps a band cell <= U_phase until
        # its completion rows, which are exactly the window rows.
        width = children[..., 1] - children[..., 0]           # (C, 4ch)
        rowmin = jnp.min(newD, axis=-1)                       # (C, 4ch)
        col_contrib = jnp.full((C, 4), INF, jnp.int8)
        cm_other_v = jnp.zeros((C,), jnp.int8)
        for w_ in range(W):
            col_contrib = jnp.where((cacc_l == w_)[:, None],
                                    new_cm_sd[:, :, w_], col_contrib)
            cm_other_v = jnp.where(cfro_l == w_, cm_other[:, w_], cm_other_v)
        bound = (jnp.minimum(rowmin, col_contrib).astype(jnp.int32)
                 + cm_other_v.astype(jnp.int32)[:, None])
        ok = act[:, None] & (width > 0) & (bound <= ub[:, None])
        if switchpoint > 0:
            narrow = ok & (width <= switchpoint)
            child_alive = ok & ~narrow
        else:
            child_alive = ok

        # BOUNDARY HARVEST as GHOSTS: a live, active lane whose every
        # child neither survives nor drains is dying because the TEXT
        # ends (mid-text, some extension char always exists); its colMin
        # registers may already record a completed occurrence. Instead of
        # a per-step scatter into the in-text buffer, the lane turns into
        # an inert GHOST in place (parent state kept, ids bit 31 set,
        # death-step back depth stashed in ids bits 21-30); one post-loop
        # compaction hands all ghosts to locate/verify.
        surv = child_alive if switchpoint <= 0 else (child_alive | narrow)
        died = act & alive & ~jnp.any(surv, axis=1)
        keepv = act & ~died   # lanes whose slot-0 value comes from a child
        new_ids = jnp.where(
            died, ids | GHOST_BIT | (jnp.minimum(dbv, 1023) << 21), ids)

        # 5) expand: child slot 0 of inactive/dying lanes passes the
        # parent through
        def sel(child_val, parent_val):
            keep = keepv.reshape((C, 1) + (1,) * (child_val.ndim - 2))
            par = jnp.broadcast_to(
                parent_val[:, None], (C, 4) + parent_val.shape[1:]
            )
            return jnp.where(keep, child_val, par)

        ch_alive = jnp.where(
            keepv[:, None],
            child_alive,
            jnp.concatenate([alive[:, None], jnp.zeros((C, 3), bool)], axis=1),
        )
        ch_ranges = jnp.where(
            ch_alive[..., None], sel(children, ranges), 0
        )                                                     # (C,4,4)
        band_b = jnp.where(
            (is_b & keepv)[:, None, None], newD,
            jnp.broadcast_to(band[:, None, 0], (C, 4, bw)))
        band_f = jnp.where(
            ((~is_b) & keepv)[:, None, None], newD,
            jnp.broadcast_to(band[:, None, 1], (C, 4, bw)))
        ch_band = jnp.stack([band_b, band_f], axis=2)         # (C,4,2,BW)
        cm_b = jnp.where((is_b & keepv)[:, None, None], new_cm_sd,
                         jnp.broadcast_to(cm0[:, None], (C, 4, Wp)))
        cm_f = jnp.where(((~is_b) & keepv)[:, None, None], new_cm_sd,
                         jnp.broadcast_to(cm1[:, None], (C, 4, Wp)))
        ch_colmin = jnp.stack([cm_b, cm_f], axis=2)           # (C,4,2,Wp)

        if switchpoint > 0:
            flat_n = narrow.reshape(-1)
            np_ = jnp.cumsum(flat_n.astype(jnp.int32)) - 1
            dest_n = jnp.where(flat_n, jnp.minimum(itv_cnt + np_, M), M)
            rows = jnp.stack([
                children[..., 0].reshape(-1),
                children[..., 1].reshape(-1),
                jnp.broadcast_to(ids_c.astype(jnp.uint32)[:, None],
                                 (C, 4)).reshape(-1),
                jnp.broadcast_to(dbv.astype(jnp.uint32)[:, None],
                                 (C, 4)).reshape(-1),
            ], axis=1)
            itv_buf2 = itv_buf.at[dest_n].set(rows, mode="drop")
            itv_cnt2 = jnp.minimum(itv_cnt + np_[-1] + 1, M)
        else:
            itv_buf2, itv_cnt2 = itv_buf, itv_cnt

        import os as _os

        ch_packed = _pack_state(
            ch_ranges,
            jnp.broadcast_to(new_ids[:, None], (C, 4)),
            ch_band, ch_colmin, bw, Wp,
        )                                                     # (C, 4, words)
        if _os.environ.get("COLUMBA_JAX_COMPACT_STEP"):
            # legacy cumsum+scatter compaction (A/B reference)
            flat_alive = ch_alive.reshape(-1)
            pos = jnp.cumsum(flat_alive.astype(jnp.int32)) - 1
            dest = jnp.where(flat_alive, pos, C)
            dest = jnp.where(pos >= C, C, dest)
            n_alive = pos[-1] + 1
            overflow = overflow + jnp.maximum(n_alive - C, 0)
            src = jnp.full((C + 1,), 4 * C, jnp.int32)
            src = src.at[dest].set(jnp.arange(4 * C, dtype=jnp.int32),
                                   mode="drop")[:C]
            live = src < 4 * C
            srcc = jnp.where(live, src, 0)
            nwords = ch_packed.shape[-1]
            new_state = jnp.where(
                live[:, None],
                ch_packed.reshape(4 * C, nwords)[srcc],
                jnp.zeros((C, nwords), jnp.uint32),
            )
            if dbg:   # per-step live-lane histogram (profiling builds)
                dbg = (dbg[0].at[t_idx].set(n_alive),)
            return (new_state, overflow, visits, itv_buf2, itv_cnt2,
                    *dbg), None

        # 6) compact 4C -> C by SORT (one lax.sort_key_val over 4C
        # uint32 index keys, alive-first in original order) + one row
        # gather of the packed state. Which compaction is faster on the
        # GPU is ROADMAP A2/C4 (tools/profile_step2.py measures both).
        flat_alive = ch_alive.reshape(-1)
        ar = jnp.arange(4 * C, dtype=jnp.uint32)
        keys = jnp.where(flat_alive, ar, jnp.uint32(4 * C) + ar)
        _, src = jax.lax.sort_key_val(keys, ar)
        src = src[:C].astype(jnp.int32)
        alive_c = flat_alive[src]
        nwords = ch_packed.shape[-1]
        new_state = jnp.where(
            alive_c[:, None],
            ch_packed.reshape(4 * C, nwords)[src],
            jnp.zeros((C, nwords), jnp.uint32),
        )
        n_alive = flat_alive.sum().astype(jnp.int32)
        overflow = overflow + jnp.maximum(n_alive - C, 0)
        if dbg:   # per-step live-lane histogram (profiling builds)
            dbg = (dbg[0].at[t_idx].set(n_alive),)
        return (new_state, overflow, visits, itv_buf2, itv_cnt2,
                *dbg), None
      return step

    def shrink(st_packed, C_new, overflow):
        """Compact a packed frontier into a smaller capacity (two-stage)."""
        Cp = st_packed.shape[0]
        alive = st_packed[:, 1] > st_packed[:, 0]  # uint32 range compare
        pos = jnp.cumsum(alive.astype(jnp.int32)) - 1
        dest = jnp.where(alive, jnp.minimum(pos, C_new), C_new)
        overflow = overflow + jnp.maximum(pos[-1] + 1 - C_new, 0)
        src = jnp.full((C_new + 1,), Cp, jnp.int32)
        src = src.at[dest].set(jnp.arange(Cp, dtype=jnp.int32), mode="drop")[:C_new]
        live = src < Cp
        out = st_packed[jnp.where(live, src, 0)]
        return jnp.where(live[:, None], out, 0), overflow

    def run_while(stepC, carry, meta_xs, t_lo, t_hi):
        """Run steps [t_lo, t_hi) with an all-dead early exit.

        The reference's DFS naturally stops when its stack empties; the
        lockstep analogue is a while_loop that exits once every lane is dead
        (with switchpoint > 0 most batches drain within a few band steps).
        """
        def cond(c):
            t, st = c[0], c[1]
            any_alive = jnp.any(st[:, 1] > st[:, 0])
            return (t < t_hi) & any_alive

        def body(c):
            t = c[0]
            meta_row = jax.lax.dynamic_index_in_dim(
                meta_xs, t, 0, keepdims=False)
            new_c, _ = stepC(tuple(c[1:]), (meta_row, t))
            return (t + 1, *new_c)

        out = jax.lax.while_loop(
            cond, body, (jnp.asarray(t_lo, jnp.int32), *carry))
        return tuple(out[1:])

    live_hist0 = jnp.zeros((), jnp.int32)
    if T > 0:
        meta_xs = (jnp.zeros((T, 1, 3), jnp.int32) if dyn is not None
                   else tables["mrow"])
        import os as _os

        step_stats = bool(_os.environ.get("COLUMBA_JAX_STEP_STATS"))
        carry = (state, overflow0, visits0, itv_buf0, itv_cnt0)
        if step_stats:
            carry = carry + (jnp.zeros((T,), jnp.int32),)
        if 0 < split_step < T and 0 < capacity2 < C:
            # stage 1 at full capacity: the switchpoint drains most lanes
            carry = run_while(make_step(C), carry, meta_xs, 0, split_step)
            state, overflow0 = shrink(carry[0], int(capacity2), carry[1])
            carry = (state, overflow0) + carry[2:]
            carry = run_while(make_step(int(capacity2)), carry, meta_xs,
                              split_step, T)
        else:
            carry = run_while(make_step(C), carry, meta_xs, 0, T)
        state, overflow0, visits0, itv_buf0, itv_cnt0 = carry[:5]
        live_hist0 = carry[5] if len(carry) > 5 else jnp.zeros((), jnp.int32)

    ranges_f, ids_f, band_f, colmin_f = _unpack_state(state, bw, Wp, rw)
    # ghosts (boundary-harvest deaths held inert in the frontier) join the
    # in-text buffer in ONE post-loop compaction; their stashed death-step
    # back depth restores the itv row layout [lo, hi, ids, db]
    ghost_f = ids_f < 0
    gpos = jnp.cumsum(ghost_f.astype(jnp.int32)) - 1
    dest_g = jnp.where(ghost_f, jnp.minimum(itv_cnt0 + gpos, M), M)
    grows = jnp.stack([
        ranges_f[:, 0], ranges_f[:, 1],
        (ids_f & GHOST_IDM).astype(jnp.uint32),
        ((ids_f >> 21) & 1023).astype(jnp.uint32),
    ], axis=1)
    itv_buf0 = itv_buf0.at[dest_g].set(grows, mode="drop")
    itv_cnt0 = jnp.minimum(itv_cnt0 + gpos[-1] + 1, M)
    ids_f = ids_f & GHOST_IDM
    sid_f = ids_f % S
    # completion bound: each side's LAST window's register (7 = side has no
    # band windows => its exact-matched extent completes at 0)
    Cf = ranges_f.shape[0]  # capacity2 when the two-stage shrink ran
    if dyn is not None:
        freg = jnp.zeros((Cf, 2), jnp.int32)
    else:  # (S, 2) static literals -> per-lane via unrolled selects
        freg = jnp.stack(
            [select_by(sid_f, [int(v) for v in sched.final_reg[:, j]])
             for j in range(2)], axis=1)
    cm_b_f = jnp.zeros((Cf,), jnp.int8)
    cm_f_f = jnp.zeros((Cf,), jnp.int8)
    arg_b_f = jnp.full((Cf,), -1, jnp.int8)   # -1: back side has no window
    for w_ in range(W):
        cm_b_f = jnp.where(freg[:, 0] == w_, colmin_f[:, 0, w_], cm_b_f)
        cm_f_f = jnp.where(freg[:, 1] == w_, colmin_f[:, 1, w_], cm_f_f)
        if track_arg:
            arg_b_f = jnp.where(freg[:, 0] == w_, colmin_f[:, 0, W + w_],
                                arg_b_f)
    ed_lb = cm_b_f.astype(jnp.int32) + cm_f_f.astype(jnp.int32)
    alive_f = (ranges_f[:, 1] > ranges_f[:, 0]) & ~ghost_f
    u_src = (dyn["u_last"] if dyn is not None
             else [int(v) for v in sched.u_last])
    done = alive_f & (ed_lb <= select_by(sid_f, u_src))
    return FrontierResult(
        ranges=ranges_f,
        rid=ids_f // S,
        sid=sid_f,
        ed_lb=ed_lb,
        done=done,
        overflow=overflow0,
        nodes_visited=visits0,
        itv=itv_buf0[:M],
        itv_count=itv_cnt0,
        searches_started=n_alive0,
        arg_b=arg_b_f,
        live_hist=live_hist0,
    )
