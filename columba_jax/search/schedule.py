"""Compile a search scheme into a static lockstep step schedule.

The reference executes searches as a per-read recursive DFS with per-phase
banded matrices and cluster-seeded direction switches
(reference: src/indexinterface.cpp:377-527 ``recApproxMatchEdit``). That
shape (data-dependent recursion, per-node matrices) cannot map to lockstep batched hardware.

This module re-derives the same lossless semantics as a **lockstep two-band
frontier program**:

* A search's text path always grows one character per step, alternating
  sides (backward/left, forward/right of a fixed *pivot*) according to the
  phase order π. The pivot is the edge of the first part where matching
  starts.
* Per node we keep TWO banded edit-distance bands, one per side:
  ``D_side[o]`` holds the banded-DP cell ``D[t][t - kb + o]`` (t = side text
  depth, j = t-kb+o = #pattern chars of that side consumed, band radius kb).
  Because the two sides align disjoint pattern substrings, the combined
  distance is ``min_j (D_back[j] + D_fwd[j'])`` and each side's DP is
  independent of the interleaving order — direction switches need no
  matrix re-seeding at all (the band simply continues when a later phase
  returns to a side). This replaces the reference's cluster machinery
  (src/indexhelpers.h:1743-1838).
* To capture alignments that consume MORE text than pattern on a side
  (insertions at a phase boundary), each side overshoots every phase extent
  by kb extra rows; a per-side running minimum ``colMin`` accumulates the
  exact column minimum ``min_t D[t][extent]`` over the rows
  ``t in [extent-kb, extent+kb]``. ``colMin`` is the side's exact
  completion distance at its current extent:
    - pruning: ``min(rowMin_active, colMin_active) + colMin_frozen > U_phase``
      kills a node (both terms are monotone lower bounds, and for any
      occurrence covered by the search, colMin_back+colMin_fwd <= errors in
      processed parts <= U_phase — so no covered occurrence is lost);
    - completion: at the final step, ``colMin_back + colMin_fwd <= U_last``.
* Leading U=0 phases are executed as plain exact extension (fan-out 1, no
  band) — the analogue of the reference's exact-prefix fast path
  (src/searchstrategy.cpp:1181-1254 ``doRecSearch``).

Everything data-dependent is reduced to per-(search, step) lookup tables;
the executor (search/executor.py) runs them inside one lax.scan.

Hamming distance is the kb=0 special case (band width 1, no overshoot).

colMin windows of consecutive extents on one side overlap whenever a part
is shorter than 2*kb+1 (e.g. k >= 7 at 100 bp: 8+ parts). Each side
therefore keeps ``W`` rotating colMin registers; windows are assigned to
registers by interval coloring over their lifetime (first accumulation row
until the NEXT window completes, since a completed value serves as the
frozen other-side bound until superseded). Windows whose nominal first row
precedes the exact-prefix extent fold the missing rows' exact-region DP
values (|extent - t0|) in at reset via the ``cini`` table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from columba_jax.search.scheme import BACKWARD, FORWARD, SearchScheme

INF = 63  # band infinity (int8-safe; band cells saturate here, which only
          # loosens bounds: every candidate is re-verified in-text anyway)
MAX_REGS = 10  # colMin registers per side (3 int32 words x 4 7-bit slots)


def _pack7(vals) -> int:
    """Pack up to 4 7-bit fields into one int32-safe int."""
    assert len(vals) <= 4
    return int(sum(int(v) << (7 * w) for w, v in enumerate(vals)))


@dataclass(frozen=True, eq=False)  # id-hash: usable as a jit static arg
class Schedule:
    """Static lockstep tables for one (scheme, pattern length, partition)."""

    k: int
    kb: int                  # band radius (k for edit, 0 for hamming)
    m: int                   # pattern length
    num_searches: int
    e_max: int               # exact-prefix steps (padded)
    t_max: int               # band steps (end-aligned, padded)
    # exact prefix tables (S, e_max)
    ex_pos: np.ndarray       # absolute read position to match, or -1 idle
    ex_dir: np.ndarray       # 0 backward / 1 forward
    db_ex: np.ndarray        # (S, e_max) back-side depth AFTER each exact
                             # step (for the in-text crossover estimate)
    # band step tables (S, t_max)
    active: np.ndarray       # bool: does search s run at step t
    side: np.ndarray         # 0 back / 1 fwd
    ub: np.ndarray           # U bound after this step
    cops: np.ndarray         # (S, T, 3) packed per-register colMin ops: 7
                             # bits per register w (4 per word): (cell 0..62,
                             # 63=idle) | reset<<6
    cini: np.ndarray         # (S, T, 3) packed per-register reset-init values
                             # (7 bits each, 63 = none/INF): exact-region DP
                             # folded in when a window starts before the band
    cacc: np.ndarray         # (S, T) register of the current phase's window
                             # (15 = none): its fresh value joins the bound
    cfro: np.ndarray         # (S, T) other side's last COMPLETED window's
                             # register (15 = none => contributes 0)
    db: np.ndarray           # (S, T) back-side depth after each band step
    db_exact: np.ndarray     # (S,) back depth right after the exact prefix
    # band cell tables (S, t_max, BW)
    posw: np.ndarray         # absolute read pos of the diag char, or 0
    mvalid: np.ndarray       # diag (match/mismatch) transition allowed
    cvalid: np.ndarray       # cell within [0, side_len]
    # per search (S,)
    u_last: np.ndarray
    t_back: np.ndarray       # final back-side text depth (incl. overshoot)
    pivot: np.ndarray
    colmin_init: np.ndarray  # (S, 2, W) initial colMin registers per side
    band_init: np.ndarray    # (S, 2, BW) initial band rows after exact prefix
    kmer_start: np.ndarray   # (S,) read pos of seed k-mer window, -1 if none
    final_reg: np.ndarray    # (S, 2) register of the last window per side
                             # (15 = side has no windows => contributes 0)
    W: int = 1               # colMin registers per side (max window overlap)
    kmer_k: int = 0          # seed k-mer length (0 = no seeding)

    @property
    def bw(self) -> int:
        return 2 * self.kb + 1


def uniform_partition(m: int, p: int) -> np.ndarray:
    """Uniform part boundaries (reference: src/searchstrategy.cpp:194-209)."""
    return np.array([(i * m) // p for i in range(p + 1)], dtype=np.int64)


def static_partition(m: int, fracs) -> np.ndarray:
    """Per-scheme optimal static boundaries
    (reference: src/searchstrategy.cpp:221-238 ``partitionOptimalStatic``)."""
    pts = [0] + [int(f * m) for f in fracs] + [m]
    return np.array(pts, dtype=np.int64)


def compile_schedule(
    scheme: SearchScheme,
    m: int,
    partition: np.ndarray | None = None,
    metric: str = "edit",
    kmer_k: int = 0,
) -> Schedule:
    """kmer_k > 0: searches whose first kmer_k exactly-matched characters
    form a contiguous window skip those steps; the executor initializes their
    ranges from the k-mer seed table instead (the reference seeds exact
    ranges from its k-mer hash the same way, src/searchstrategy.cpp:158-190).
    """
    k = scheme.k
    kb = k if metric == "edit" else 0
    bw = 2 * kb + 1
    p = scheme.num_parts
    pts = uniform_partition(m, p) if partition is None else np.asarray(partition)
    assert len(pts) == p + 1 and pts[0] == 0 and pts[-1] == m
    part_lens = np.diff(pts)
    if part_lens.min() < 1:
        raise ValueError(
            f"empty part: pattern length {m} too short for {p} parts"
        )
    if 2 * kb > 62:
        raise ValueError(f"band radius {kb} > 31 exceeds the colMin cell "
                         "packing (reference MAX_K_EDIT=20, "
                         "src/bitparallelmatrix.h:309-316)")

    S = len(scheme.searches)
    per_search = []
    for s in scheme.searches:
        ps = _compile_one(s, pts, kb)
        ps["kmer_start"] = -1
        if kmer_k > 0 and len(ps["ex_pos"]) >= kmer_k:
            head = ps["ex_pos"][:kmer_k]
            if np.all(np.diff(head) == 1):
                ps["kmer_start"] = int(head[0])
            elif np.all(np.diff(head) == -1):
                ps["kmer_start"] = int(head[-1])
            if ps["kmer_start"] >= 0:
                ps["ex_pos"] = ps["ex_pos"][kmer_k:]
                ps["ex_dir"] = ps["ex_dir"][kmer_k:]
                ps["db_ex"] = ps["db_ex"][kmer_k:]
        per_search.append(ps)

    e_max = max(len(ps["ex_pos"]) for ps in per_search)
    t_max = max(len(ps["side"]) for ps in per_search)
    W = max(ps["n_regs"] for ps in per_search)
    if W > MAX_REGS:
        raise ValueError(
            f"colMin window overlap {W} > {MAX_REGS}: parts too short for "
            f"k={k} (read length {m})"
        )

    cops_idle = _pack7([63] * 4)
    cini_idle = _pack7([63] * 4)
    ex_pos = np.full((S, e_max), -1, dtype=np.int32)
    ex_dir = np.zeros((S, e_max), dtype=np.int32)
    db_ex = np.zeros((S, e_max), dtype=np.int32)
    active = np.zeros((S, t_max), dtype=bool)
    side = np.zeros((S, t_max), dtype=np.int32)
    ub = np.full((S, t_max), k, dtype=np.int32)
    cops = np.full((S, t_max, 3), cops_idle, dtype=np.int32)
    cini = np.full((S, t_max, 3), cini_idle, dtype=np.int32)
    cacc = np.full((S, t_max), 15, dtype=np.int32)
    cfro = np.full((S, t_max), 15, dtype=np.int32)
    db = np.zeros((S, t_max), dtype=np.int32)
    db_exact = np.zeros(S, dtype=np.int32)
    band_init = np.full((S, 2, bw), INF, dtype=np.int32)
    posw = np.zeros((S, t_max, bw), dtype=np.int32)
    mvalid = np.zeros((S, t_max, bw), dtype=bool)
    cvalid = np.zeros((S, t_max, bw), dtype=bool)
    u_last = np.zeros(S, dtype=np.int32)
    t_back = np.zeros(S, dtype=np.int32)
    pivot = np.zeros(S, dtype=np.int32)
    colmin_init = np.zeros((S, 2, W), dtype=np.int32)
    final_reg = np.full((S, 2), 15, dtype=np.int32)
    kmer_start = np.full(S, -1, dtype=np.int32)

    for i, ps in enumerate(per_search):
        kmer_start[i] = ps["kmer_start"]
        e = len(ps["ex_pos"])
        ex_pos[i, :e] = ps["ex_pos"]
        ex_dir[i, :e] = ps["ex_dir"]
        db_ex[i, :e] = ps["db_ex"]
        db_ex[i, e:] = ps["db_exact"]
        t = len(ps["side"])
        off = t_max - t  # end-aligned
        active[i, off:] = True
        side[i, off:] = ps["side"]
        ub[i, off:] = ps["ub"]
        cops[i, off:] = ps["cops"]
        cini[i, off:] = ps["cini"]
        cacc[i, off:] = ps["cacc"]
        cfro[i, off:] = ps["cfro"]
        db[i, off:] = ps["db"]
        db[i, :off] = ps["db_exact"]
        db_exact[i] = ps["db_exact"]
        posw[i, off:] = ps["posw"]
        mvalid[i, off:] = ps["mvalid"]
        cvalid[i, off:] = ps["cvalid"]
        u_last[i] = ps["u_last"]
        t_back[i] = ps["t_back"]
        pivot[i] = ps["pivot"]
        band_init[i] = ps["band_init"]
        final_reg[i] = ps["final_reg"]

    return Schedule(
        k=k, kb=kb, m=m, num_searches=S, e_max=e_max, t_max=t_max,
        ex_pos=ex_pos, ex_dir=ex_dir, db_ex=db_ex,
        active=active, side=side, ub=ub,
        cops=cops, cini=cini, cacc=cacc, cfro=cfro, db=db, db_exact=db_exact,
        posw=posw, mvalid=mvalid, cvalid=cvalid,
        u_last=u_last, t_back=t_back, pivot=pivot, colmin_init=colmin_init,
        band_init=band_init, kmer_start=kmer_start, final_reg=final_reg,
        W=W, kmer_k=kmer_k,
    )


def _compile_one(search, pts, kb):
    """Per-search schedule: exact prefix steps + band steps."""
    p = search.num_parts
    dirs = search.directions
    pi0 = search.pi[0]
    piv = int(pts[pi0] if dirs[0] == FORWARD else pts[pi0 + 1])
    m = int(pts[-1])
    side_len = {0: piv, 1: m - piv}  # back / fwd pattern lengths

    # per-phase side extents
    extents = []  # (back_extent, fwd_extent) after each phase
    for lo, hi in search.part_extent:
        extents.append((piv - int(pts[lo]), int(pts[hi + 1]) - piv))

    n_exact = search.num_exact_prefix_phases
    # ---- exact prefix: pattern positions consumed, in order ----
    ex_pos, ex_dir, db_ex = [], [], []
    b_prev, f_prev = 0, 0
    for i in range(n_exact):
        be, fe = extents[i]
        if dirs[i] == BACKWARD:
            for j in range(b_prev + 1, be + 1):  # j-th back char = pos piv-j
                ex_pos.append(piv - j)
                ex_dir.append(0)
                db_ex.append(j)
        else:
            for j in range(f_prev + 1, fe + 1):  # j-th fwd char = pos piv+j-1
                ex_pos.append(piv + j - 1)
                ex_dir.append(1)
                db_ex.append(b_prev)
        b_prev, f_prev = be, fe

    # exact depths after the prefix
    depth = [b_prev, f_prev]
    exact_extent = (b_prev, f_prev)

    # ---- band phases ----
    side_l, ubv, db_rows, row_depth, row_phase = [], [], [], [], []
    posw, mvalid, cvalid = [], [], []

    def emit_row(sd, t_new, u):
        """One band row at depth t_new on side sd."""
        side_l.append(sd)
        ubv.append(u)
        row_depth.append(t_new)
        row_pos = np.zeros(2 * kb + 1, dtype=np.int32)
        row_mv = np.zeros(2 * kb + 1, dtype=bool)
        row_cv = np.zeros(2 * kb + 1, dtype=bool)
        for o in range(2 * kb + 1):
            j = t_new - kb + o
            if 0 <= j <= side_len[sd]:
                row_cv[o] = True
                if j >= 1:
                    row_mv[o] = True
                    row_pos[o] = piv - j if sd == 0 else piv + j - 1
        posw.append(row_pos)
        mvalid.append(row_mv)
        cvalid.append(row_cv)

    windows = {0: [], 1: []}  # per side, in phase order
    for i in range(n_exact, p):
        sd = 0 if dirs[i] == BACKWARD else 1
        be, fe = extents[i]
        target = be if sd == 0 else fe
        goal = min(target + kb, side_len[sd] + kb)
        windows[sd].append(dict(extent=target, phase=i))
        while depth[sd] < goal:
            depth[sd] += 1
            emit_row(sd, depth[sd], search.upper[i])
            row_phase.append(i)
            db_rows.append(depth[0])

    # ---- colMin windows -> rotating registers ----
    # Window n (side sd, extent E): accumulates cell j == E over emitted
    # rows at depths [max(E-kb, t0+1), E+kb]; rows at depths <= t0 lie in
    # the exact-matched region where D[t][E] = E - t (folded in at reset
    # via cini). Its value must survive as the side's frozen completion
    # bound until the NEXT window on that side completes, so its register
    # lifetime is [first row, next window's last row].
    T_s = len(side_l)
    rowidx = {(sd, t): gi
              for gi, (sd, t) in enumerate(zip(side_l, row_depth))}
    for sd in (0, 1):
        ws = windows[sd]
        for n, w in enumerate(ws):
            E = w["extent"]
            t0 = exact_extent[sd]
            w["first_d"] = max(E - kb, t0 + 1)
            w["first"] = rowidx[(sd, w["first_d"])]
            w["last"] = rowidx[(sd, E + kb)]
            w["init"] = (E - t0) if (E - kb) <= t0 else None
        busy = []  # (register, lifetime end in global rows)
        for n, w in enumerate(ws):
            life_end = ws[n + 1]["last"] if n + 1 < len(ws) else T_s
            used = {r for r, until in busy if until >= w["first"]}
            r = 0
            while r in used:
                r += 1
            w["reg"] = r
            busy.append((r, life_end))
    n_regs = max([w["reg"] for sd in (0, 1) for w in windows[sd]],
                 default=0) + 1

    cops = np.full((T_s, 3), _pack7([63] * 4), dtype=np.int32)
    cini = np.full((T_s, 3), _pack7([63] * 4), dtype=np.int32)
    cacc = np.full(T_s, 15, dtype=np.int32)
    cfro = np.full(T_s, 15, dtype=np.int32)

    def set_slot(tab, gi, r, val):
        wd, sh = r // 4, 7 * (r % 4)
        tab[gi, wd] = np.int32((int(tab[gi, wd]) & ~(127 << sh)) | (val << sh))

    win_of_phase = {w["phase"]: w for sd in (0, 1) for w in windows[sd]}
    for sd in (0, 1):
        for w in windows[sd]:
            E, r = w["extent"], w["reg"]
            for d in range(w["first_d"], E + kb + 1):
                gi = rowidx[(sd, d)]
                set_slot(cops, gi, r,
                         (E - d + kb) | ((d == w["first_d"]) << 6))
                if d == w["first_d"] and w["init"] is not None:
                    set_slot(cini, gi, r, min(w["init"], 62))
    for gi in range(T_s):
        sd, i = side_l[gi], row_phase[gi]
        w = win_of_phase[i]
        if row_depth[gi] >= w["first_d"]:
            cacc[gi] = w["reg"]
        completed = [v for v in windows[1 - sd] if v["last"] < gi]
        if completed:
            cfro[gi] = completed[-1]["reg"]
    final_reg = np.array(
        [windows[0][-1]["reg"] if windows[0] else 15,
         windows[1][-1]["reg"] if windows[1] else 15], dtype=np.int32)

    # Initial band row per side at depth t0 (= exact extent): the exact DP
    # values D[t0][j] = |j - t0| for valid j (the first t0 text chars equal
    # the first t0 pattern chars, so the best alignment to j pattern chars
    # pads with |j - t0| indels). Cells outside [0, side_len] are INF.
    # A diagonal-only init would overcount alignments that start with
    # pattern-insertions at a side boundary and wrongly prune them.
    band_init = np.full((2, 2 * kb + 1), INF, dtype=np.int32)
    for sd in (0, 1):
        t0 = exact_extent[sd]
        for o in range(2 * kb + 1):
            j = t0 - kb + o
            if 0 <= j <= side_len[sd]:
                band_init[sd, o] = abs(j - t0)

    return dict(
        ex_pos=np.array(ex_pos, dtype=np.int32),
        ex_dir=np.array(ex_dir, dtype=np.int32),
        db_ex=np.array(db_ex, dtype=np.int32),
        side=np.array(side_l, dtype=np.int32),
        ub=np.array(ubv, dtype=np.int32),
        db=np.array(db_rows, dtype=np.int32),
        db_exact=b_prev,
        cops=cops,
        cini=cini,
        cacc=cacc,
        cfro=cfro,
        n_regs=n_regs,
        final_reg=final_reg,
        posw=np.array(posw, dtype=np.int32).reshape(-1, 2 * kb + 1),
        mvalid=np.array(mvalid, dtype=bool).reshape(-1, 2 * kb + 1),
        cvalid=np.array(cvalid, dtype=bool).reshape(-1, 2 * kb + 1),
        u_last=search.upper[-1],
        t_back=depth[0],
        pivot=piv,
        band_init=band_init,
    )
