"""Parametric (per-read) schedules: dynamic partitioning support.

The static schedule compiler (search/schedule.py) bakes one partition into
per-(search, step) tables. Dynamic partitioning (the reference's default,
src/searchstrategy.cpp:240-420) gives every read its own part boundaries, so
here the same tables are computed **on device, per (read, search)** from a
boundary tensor ``pts (R, p+1)``:

* the per-phase arithmetic (pivot, side targets, overshoots, colMin windows,
  band-cell pattern positions) is exactly the static compiler's, vectorized
  over reads;
* total band steps per search are bounded by m + 2*kb (pivot position
  cancels out), so the lockstep scan stays static-shape — searches with
  shorter schedules idle at the start (end-aligned via the active bit);
* the executor's step code is unchanged except that the packed per-step
  scalar word and the pattern-char windows come from per-(read, search)
  tables indexed by ``ids * T + t``.

Constraint: every part must exceed 2*kb (same overshoot construction as the
static compiler); ``clamp_partition`` enforces it on generated boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.search.scheme import BACKWARD, FORWARD, SearchScheme
from columba_jax.search.schedule import INF


@dataclass(frozen=True, eq=False)
class SchemeStatic:
    """Static per-search structure (partition-independent)."""

    k: int
    kb: int
    m: int
    p: int
    num_searches: int
    t_max: int               # static bound on band steps (m + 2*kb)
    e_max: int               # static bound on exact steps
    # (S, p) arrays
    side: np.ndarray         # phase side 0/1
    upper: np.ndarray        # phase U
    lo: np.ndarray           # lowest part after phase
    hi: np.ndarray           # highest part after phase
    is_exact: np.ndarray     # leading U==0 phases
    # (S,)
    pi0: np.ndarray
    pivot_left: np.ndarray   # pivot at left edge of start part?
    u_last: np.ndarray
    n_exact: np.ndarray


def scheme_static(scheme: SearchScheme, m: int, metric: str = "edit") -> SchemeStatic:
    k = scheme.k
    kb = k if metric == "edit" else 0
    p = scheme.num_parts
    S = len(scheme.searches)
    side = np.zeros((S, p), np.int32)
    upper = np.zeros((S, p), np.int32)
    lo = np.zeros((S, p), np.int32)
    hi = np.zeros((S, p), np.int32)
    is_exact = np.zeros((S, p), bool)
    pi0 = np.zeros(S, np.int32)
    pivot_left = np.zeros(S, bool)
    u_last = np.zeros(S, np.int32)
    n_exact = np.zeros(S, np.int32)
    for i, s in enumerate(scheme.searches):
        side[i] = [0 if d == BACKWARD else 1 for d in s.directions]
        upper[i] = s.upper
        lo[i] = [e[0] for e in s.part_extent]
        hi[i] = [e[1] for e in s.part_extent]
        ne = s.num_exact_prefix_phases
        is_exact[i, :ne] = True
        n_exact[i] = ne
        pi0[i] = s.pi[0]
        pivot_left[i] = s.directions[0] == FORWARD
        u_last[i] = s.upper[-1]
    return SchemeStatic(
        k=k, kb=kb, m=m, p=p, num_searches=S,
        t_max=m + 2 * kb, e_max=m,
        side=side, upper=upper, lo=lo, hi=hi, is_exact=is_exact,
        pi0=pi0, pivot_left=pivot_left, u_last=u_last, n_exact=n_exact,
    )


def clamp_partition(pts: jax.Array, m: int, kb: int) -> jax.Array:
    """Enforce part length >= 2*kb+1 by sweeping boundaries (R, p+1)."""
    if kb == 0:
        return pts
    minlen = 2 * kb + 1
    p = pts.shape[1] - 1
    out = [jnp.zeros(pts.shape[0], jnp.int32)]
    for i in range(1, p):
        out.append(jnp.maximum(pts[:, i], out[-1] + minlen))
    out.append(jnp.full(pts.shape[0], m, jnp.int32))
    fwd = jnp.stack(out, axis=1)
    # backward sweep to respect the right edge as well
    res = [fwd[:, p]]
    for i in range(p - 1, 0, -1):
        res.append(jnp.minimum(fwd[:, i], res[-1] - minlen))
    res.append(jnp.zeros(pts.shape[0], jnp.int32))
    return jnp.stack(res[::-1], axis=1)


def build_tables(st: SchemeStatic, pts: jax.Array, reads: jax.Array) -> dict:
    """Per-(read, search) schedule tables from boundaries pts (R, p+1).

    Returns device arrays:
      meta   (R*S, T) int32 packed per-step scalars (dyn layout decoded by
             the executor: active|side|creset<<2|(colo+1)<<3|ub<<9|db<<17)
      pchars (R*S*T, BW) int8 band-cell codes (validity folded in)
      ex_pos (R*S, E) int32 exact-prefix read positions (-1 idle)
      ex_dir (R*S, E) int32
      band_init (R*S, 2, BW) int8;  colmin_init (R*S, 2) int8
      t_back, pivot (R*S,) int32;  u_last (S,) int32
    """
    R = pts.shape[0]
    S, p, kb, m, T = st.num_searches, st.p, st.kb, st.m, st.t_max
    bw = 2 * kb + 1

    side = jnp.asarray(st.side)          # (S, p)
    upper = jnp.asarray(st.upper)
    lo = jnp.asarray(st.lo)
    hi = jnp.asarray(st.hi)
    is_ex = jnp.asarray(st.is_exact)
    pi0 = jnp.asarray(st.pi0)
    pv_left = jnp.asarray(st.pivot_left)

    # pivot (R, S)
    pivot = jnp.where(
        pv_left[None, :],
        pts[:, :][jnp.arange(R)[:, None], pi0[None, :]],
        pts[jnp.arange(R)[:, None], (pi0 + 1)[None, :]],
    ).astype(jnp.int32)

    # per-phase targets (R, S, p)
    pts_lo = pts[jnp.arange(R)[:, None, None], lo[None]]        # (R,S,p)
    pts_hi1 = pts[jnp.arange(R)[:, None, None], (hi + 1)[None]]
    bt = pivot[:, :, None] - pts_lo                              # back targets
    ft = pts_hi1 - pivot[:, :, None]                             # fwd targets
    tgt = jnp.where(side[None] == 0, bt, ft)                     # (R,S,p)

    # depth progression over phases: depth of each side after each phase
    is_b = (side == 0)[None]                                     # (1,S,p)
    db_list, df_list = [], []
    db = jnp.zeros((R, S), jnp.int32)
    df = jnp.zeros((R, S), jnp.int32)
    prev_depth_list, steps_list, db_before_list = [], [], []
    for i in range(p):
        db_before_list.append(db)
        ex = is_ex[None, :, i]
        target_i = tgt[:, :, i]
        new_depth = jnp.where(ex, target_i, target_i + kb)
        cur = jnp.where(is_b[:, :, i], db, df)
        prev_depth_list.append(cur)
        step_i = jnp.maximum(new_depth - cur, 0)
        steps_list.append(step_i)
        db = jnp.where(is_b[:, :, i], jnp.maximum(db, new_depth), db)
        df = jnp.where(~is_b[:, :, i], jnp.maximum(df, new_depth), df)
        db_list.append(db)
        df_list.append(df)
    t_back = db                                                  # (R,S)
    prev_depth = jnp.stack(prev_depth_list, axis=2)              # (R,S,p)
    steps = jnp.stack(steps_list, axis=2)                        # (R,S,p)
    db_before = jnp.stack(db_before_list, axis=2)                # (R,S,p)

    ex_steps = jnp.where(is_ex[None], steps, 0)
    band_steps = jnp.where(is_ex[None], 0, steps)
    e_len = ex_steps.sum(axis=2)                                 # (R,S)
    t_len = band_steps.sum(axis=2)                               # (R,S)
    ex_cum = jnp.cumsum(ex_steps, axis=2)                        # end offsets
    band_cum = jnp.cumsum(band_steps, axis=2)

    side_len = jnp.stack([pivot, m - pivot], axis=-1)            # (R,S,2)

    # ---------------- band meta / pchars over the T axis ----------------
    g = jnp.arange(T, dtype=jnp.int32)                           # global step
    t_loc = g[None, None, :] - (T - t_len[:, :, None])           # (R,S,T)
    active = t_loc >= 0
    # phase of each band step: first i with band_cum_i > t_loc
    tb = jnp.clip(t_loc, 0, None)
    phase = jnp.sum((band_cum[:, :, :, None] <= tb[:, :, None, :]), axis=2)
    phase = jnp.clip(phase, 0, p - 1)                            # (R,S,T)

    # gather per-phase values at each step (take_along_axis over p axis)
    def sel_phase(arr):  # (R,S,p) -> (R,S,T)
        return jnp.take_along_axis(arr, phase, axis=2)

    side_t = sel_phase(jnp.broadcast_to(side[None].astype(jnp.int32), (R, S, p)))
    ub_t = sel_phase(jnp.broadcast_to(upper[None].astype(jnp.int32), (R, S, p)))
    tgt_t = sel_phase(tgt)
    prev_t = sel_phase(prev_depth)
    band_cum_prev = jnp.concatenate(
        [jnp.zeros((R, S, 1), jnp.int32), band_cum[:, :, :-1]], axis=2)
    cum_prev_t = sel_phase(band_cum_prev)

    t_new = prev_t + (tb - cum_prev_t) + 1                       # (R,S,T)
    in_window = t_new >= (tgt_t - kb)
    o_acc = tgt_t - t_new + kb
    window_start = prev_t + 1
    creset = active & in_window & (t_new == jnp.maximum(window_start, tgt_t - kb))
    colo = jnp.where(active & in_window & (o_acc >= 0) & (o_acc < bw), o_acc, -1)

    db_t = jnp.where(side_t == 0, t_new, sel_phase(db_before))
    meta = (
        active.astype(jnp.int32)
        | (side_t << 1)
        | (creset.astype(jnp.int32) << 2)
        | ((colo + 1) << 3)
        | (ub_t << 9)
        | (jnp.clip(db_t, 0, 4095) << 17)
    )                                                            # (R,S,T)

    # pchars codes per band cell
    o = jnp.arange(bw, dtype=jnp.int32)
    j = t_new[..., None] - kb + o                                # (R,S,T,BW)
    sl = jnp.where(side_t == 0, pivot[:, :, None], m - pivot[:, :, None])
    cvalid = (j >= 0) & (j <= sl[..., None])
    mvalid = (j >= 1) & (j <= sl[..., None])
    pos = jnp.where(side_t[..., None] == 0,
                    pivot[:, :, None, None] - j,
                    pivot[:, :, None, None] + j - 1)
    pos_c = jnp.clip(pos, 0, m - 1)
    chars = reads[jnp.arange(R)[:, None, None, None], pos_c].astype(jnp.int8)
    pchars = jnp.where(~cvalid, jnp.int8(-2),
                       jnp.where(~mvalid, jnp.int8(-1), chars))

    # ---------------- exact prefix tables ----------------
    E = int(st.e_max)
    e = jnp.arange(E, dtype=jnp.int32)
    e_act = e[None, None, :] < e_len[:, :, None]                 # (R,S,E)
    ephase = jnp.sum(ex_cum[:, :, :, None] <= e[None, None, None, :], axis=2)
    ephase = jnp.clip(ephase, 0, p - 1)

    def sel_eph(arr):
        return jnp.take_along_axis(arr, ephase, axis=2)

    eside = sel_eph(jnp.broadcast_to(side[None].astype(jnp.int32), (R, S, p)))
    eprev = sel_eph(prev_depth)
    ecum_prev = sel_eph(jnp.concatenate(
        [jnp.zeros((R, S, 1), jnp.int32), ex_cum[:, :, :-1]], axis=2))
    ej = eprev + (e[None, None, :] - ecum_prev) + 1              # chars consumed
    ex_pos = jnp.where(eside == 0, pivot[:, :, None] - ej,
                      pivot[:, :, None] + ej - 1)
    ex_pos = jnp.where(e_act, ex_pos, -1)
    ex_dir = eside

    # ---------------- band init ----------------
    exact_extent = jnp.stack(
        [jnp.where(is_b & is_ex[None], tgt, 0).max(axis=2),
         jnp.where((~is_b) & is_ex[None], tgt, 0).max(axis=2)], axis=-1
    )                                                            # (R,S,2)
    t0 = exact_extent[..., None]                                 # (R,S,2,1)
    jj = t0 - kb + o                                             # (R,S,2,BW)
    binit = jnp.where(
        (jj >= 0) & (jj <= side_len[..., None]),
        jnp.abs(jj - t0), INF,
    ).astype(jnp.int8)

    return dict(
        meta=meta.reshape(R * S, T),
        pchars=pchars.reshape(R * S * T, bw),
        ex_pos=ex_pos.reshape(R * S, E),
        ex_dir=ex_dir.reshape(R * S, E),
        db_ex_steps=jnp.cumsum(
            (e_act & (eside == 0)).astype(jnp.int32), axis=2
        ).reshape(R * S, E),
        band_init=binit.reshape(R * S, 2, bw),
        colmin_init=jnp.zeros((R * S, 2), jnp.int8),
        t_back=t_back.reshape(R * S),
        pivot=pivot.reshape(R * S),
        u_last=jnp.asarray(st.u_last),
        db_exact=exact_extent[..., 0].reshape(R * S),
    )


def dynamic_partition(
    index,
    reads: jax.Array,
    scheme: SearchScheme,
    kmer_table: jax.Array | None = None,
) -> jax.Array:
    """Batched greedy dynamic partitioning (reference default,
    src/searchstrategy.cpp:240-420 ``partitionDynamic``/``seed``).

    Seeds each part (k-mer table when available, else single characters) at
    the scheme's seeding positions, then repeatedly extends the part with
    the largest weighted exact-match range by one character — toward its
    smaller neighbour when both directions are open — in R-parallel
    lockstep. Returns boundaries pts (R, p+1) (clamp before scheduling).
    """
    from columba_jax.index import kmer as kmer_mod
    from columba_jax.ops import extend as ext

    R, m = reads.shape
    p = scheme.num_parts
    K = kmer_mod.table_k(kmer_table) if kmer_table is not None else 1
    if p * K >= (2 * m) // 3:
        K, kmer_table = 1, None

    # seed starts (reference seed(): first at 0, middles at frac*m - K/2,
    # last at m-K)
    if scheme.seed_fracs and len(scheme.seed_fracs) == p - 2:
        mids = [int(f * m) - K // 2 for f in scheme.seed_fracs]
    else:
        mids = [(i * m) // p for i in range(1, p - 1)]
    seeds = [0] + mids + [m - K]
    begins = jnp.broadcast_to(
        jnp.asarray(seeds, jnp.int32), (R, p)).copy()
    ends = begins + K

    weights = jnp.asarray(
        scheme.weights if scheme.weights and len(scheme.weights) == p
        else [1] * p, jnp.int32)

    # initial ranges
    if kmer_table is not None:
        offs = jnp.arange(K, dtype=jnp.int32)
        wchars = reads[jnp.arange(R)[:, None, None],
                       jnp.clip(begins[:, :, None] + offs, 0, m - 1)]
        ranges = kmer_mod.lookup(kmer_table, wchars)          # (R,p,rw)
    else:
        # single-char seed ranges: one backward extension of the full
        # range yields [counts[c], counts[c+1]) — and, on the RLC
        # backend, the matching run hints — for both flavors
        c0 = reads[jnp.arange(R)[:, None], begins].astype(jnp.int32)
        ranges = ext.extend_char(
            index, index.full_range((R, p)), c0,
            jnp.zeros((R, p), jnp.int32))

    steps = m - p * K

    def body(carry, _):
        begins, ends, ranges = carry
        # uint32 widths, clamped to 2^30 and cast signed for the weighted
        # argmax / sentinel arithmetic (distinctions above 2^30 exact
        # matches carry no information for partitioning)
        widths = jnp.minimum(ranges[..., 1] - ranges[..., 0],
                             jnp.uint32(1 << 30)).astype(jnp.int32)  # (R,p)
        prev_end = jnp.concatenate(
            [jnp.zeros((R, 1), jnp.int32), ends[:, :-1]], axis=1)
        next_beg = jnp.concatenate(
            [begins[:, 1:], jnp.full((R, 1), m, jnp.int32)], axis=1)
        can_left = begins > prev_end
        can_right = ends < next_beg
        extendable = can_left | can_right
        weighted = jnp.where(extendable, widths * weights[None], -1)
        part = jnp.argmax(weighted, axis=1)                   # (R,)
        onehot = jax.nn.one_hot(part, p, dtype=jnp.bool_)     # (R,p)

        sel = lambda a: jnp.take_along_axis(a, part[:, None], axis=1)[:, 0]
        cl = sel(can_left)
        cr = sel(can_right)
        # neighbour widths for the tie direction
        wl = sel(jnp.concatenate(
            [jnp.full((R, 1), 1 << 30, jnp.int32), widths[:, :-1]], axis=1))
        wr = sel(jnp.concatenate(
            [widths[:, 1:], jnp.full((R, 1), 1 << 30, jnp.int32)], axis=1))
        go_back = jnp.where(~cl, False, jnp.where(~cr, True, wl < wr))

        b = sel(begins)
        e = sel(ends)
        newpos = jnp.where(go_back, b - 1, e)
        chars = reads[jnp.arange(R), jnp.clip(newpos, 0, m - 1)]
        cur = jnp.take_along_axis(
            ranges, part[:, None, None].repeat(ranges.shape[-1], axis=2),
            axis=1)[:, 0]
        dirs = jnp.where(go_back, 0, 1).astype(jnp.int32)
        any_ext = sel(extendable)
        new_rng = ext.extend_char(index, cur, chars.astype(jnp.int32), dirs)

        begins2 = jnp.where(onehot & go_back[:, None] & any_ext[:, None],
                            begins - 1, begins)
        ends2 = jnp.where(onehot & (~go_back)[:, None] & any_ext[:, None],
                          ends + 1, ends)
        ranges2 = jnp.where(
            (onehot & any_ext[:, None])[:, :, None], new_rng[:, None, :],
            ranges)
        return (begins2, ends2, ranges2), None

    if steps > 0:
        (begins, ends, ranges), _ = jax.lax.scan(
            body, (begins, ends, ranges), None, length=steps)

    # close any remaining gaps (reference extendParts): boundary = next begin
    pts_mid = []
    for i in range(1, p):
        pts_mid.append(begins[:, i])
    pts = jnp.stack(
        [jnp.zeros(R, jnp.int32)] + pts_mid + [jnp.full(R, m, jnp.int32)],
        axis=1,
    )
    return pts
