"""Batched bidirectional extension on the b-move (RLC) index.

Batched replacement of the reference's run-walking extension
(reference: src/bmove/moverepr.cpp:313-330 ``addChar``, :287-297
``fastForward``, :332-368 ``countChar``/``getCumulativeCounts``): per
frontier node, TWO fused-row gathers (run of lo, run of hi-1) provide char
identity, per-char cumulative counts, and next/prev-run-of-char pointers
for all four characters at once; the only data-dependent iteration left is
the fast-forward of run hints, batched over (lane, char, endpoint) in one
while_loop whose trip count is the maximum interval overlap.

Node state (see index/bmove.py): ``[f_lo, f_hi, r_lo, r_hi,
f_run_lo, f_run_hi1, r_run_lo, r_run_hi1]``. The synchronized other-side
range is updated arithmetically exactly like the FM-index path
(smaller-char counts; '$' count falls out as width - sum(char widths));
its run hints are maintained by monotone fast-forward/back-walk from the
previous hints (the range only ever narrows).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from columba_jax.index.bmove import (
    BMoveIndex, START, END, LF_POS, LF_RUN, CHAR, SA_FIRST, SA_LAST,
    NEXT0, PREV0, CUM0,
)


# Linear fast-forward iterations before the binary-search fallback kicks
# in. The hint walk is O(interval overlap) — usually 0-2 steps mid-search —
# but with no k-mer seeding the first extensions of the FULL range span
# ~r/4 runs, and an uncapped lockstep walk then runs max-over-lanes x 10^4+
# iterations, each a round of device work. The reference's
# pointer walk (moverepr.cpp:287-297 fastForward) never sees this because
# its per-node steps are tiny; the batched design needs the bound.
FF_CAP = 16


def _run_of_pos(index: BMoveIndex, off, pos, lo):
    """Largest run j (>= lo) of the off-selected table with START[j] <=
    pos: bounded binary search, ceil(log2(max r)) fused-row gathers."""
    r_limit = jnp.where(off == 0, index.r_fwd, index.r_rev)
    lo = jnp.clip(lo, 0, r_limit - 1)
    hi = r_limit - 1
    bits = max(int(index.r_fwd).bit_length(),
               int(index.r_rev).bit_length())
    for _ in range(bits):
        mid = (lo + hi + 1) >> 1
        st = index.fused[off + mid, START]
        take = st <= pos
        lo = jnp.where(take, mid, lo)
        hi = jnp.where(take, hi, mid - 1)
    return lo


def _ff_forward(index: BMoveIndex, off, run, pos):
    """Advance run hints while interval end <= pos (batched, capped walk +
    binary-search fallback so the lockstep trip count stays bounded)."""
    def cond(c):
        run, it = c
        end = index.fused[off + run, END]
        return (it < FF_CAP) & jnp.any(end <= pos)

    def body(c):
        run, it = c
        end = index.fused[off + run, END]
        return jnp.where(end <= pos, run + 1, run), it + 1

    run, _ = jax.lax.while_loop(cond, body, (run, jnp.zeros((), jnp.int32)))
    behind = index.fused[off + run, END] <= pos
    return jax.lax.cond(
        jnp.any(behind),
        lambda r: jnp.where(behind, _run_of_pos(index, off, pos, r), r),
        lambda r: r,
        run)


def _ff_backward(index: BMoveIndex, off, run, pos):
    """Retreat run hints while interval start > pos (batched, capped walk +
    binary-search fallback; see _ff_forward)."""
    def cond(c):
        run, it = c
        return (it < FF_CAP) & jnp.any(index.fused[off + run, START] > pos)

    def body(c):
        run, it = c
        st = index.fused[off + run, START]
        return jnp.where(st > pos, run - 1, run), it + 1

    run, _ = jax.lax.while_loop(cond, body, (run, jnp.zeros((), jnp.int32)))
    ahead = index.fused[off + run, START] > pos
    return jax.lax.cond(
        jnp.any(ahead),
        lambda r: jnp.where(ahead, _run_of_pos(index, off, pos,
                                               jnp.zeros_like(r)), r),
        lambda r: r,
        run)


def extend_all(index: BMoveIndex, ranges: jax.Array, dirs: jax.Array) -> jax.Array:
    """Extend every node by all 4 characters. ranges: (..., 8) uint32
    (positions; run-hint slots carry int32 bit patterns).

    Returns (..., 4, 8) children (empty children have hi <= lo and zeroed
    hints). Dead input lanes must be all-zero (safe gathers).
    """
    ranges = ranges.astype(jnp.uint32)
    f_lo, f_hi, r_lo, r_hi = (ranges[..., i] for i in range(4))
    # run hints are indices < 2^31: bit-cast back to signed for arithmetic
    fr_lo, fr_hi1, rr_lo, rr_hi1 = (
        ranges[..., i].astype(jnp.int32) for i in range(4, 8))
    bwd = dirs == 0
    off_a = jnp.where(bwd, 0, index.r_fwd + 1)
    off_b = jnp.where(bwd, index.r_fwd + 1, 0)
    a_lo = jnp.where(bwd, f_lo, r_lo)
    a_hi = jnp.where(bwd, f_hi, r_hi)
    a_run_lo = jnp.where(bwd, fr_lo, rr_lo)
    a_run_hi1 = jnp.where(bwd, fr_hi1, rr_hi1)
    b_lo = jnp.where(bwd, r_lo, f_lo)
    b_run_lo = jnp.where(bwd, rr_lo, fr_lo)
    b_run_hi1 = jnp.where(bwd, rr_hi1, fr_hi1)

    row_lo = index.fused[off_a + a_run_lo]        # (..., NCOLS) uint32
    row_hi = index.fused[off_a + a_run_hi1]
    char_lo = row_lo[..., CHAR].astype(jnp.int32)
    char_hi = row_hi[..., CHAR].astype(jnp.int32)

    cvec = jnp.arange(4, dtype=jnp.int32)
    occ_lo = (row_lo[..., CUM0:CUM0 + 4]
              + jnp.where(char_lo[..., None] == cvec,
                          (a_lo - row_lo[..., START])[..., None],
                          jnp.uint32(0)))
    occ_hi = (row_hi[..., CUM0:CUM0 + 4]
              + jnp.where(char_hi[..., None] == cvec,
                          (a_hi - row_hi[..., START])[..., None],
                          jnp.uint32(0)))
    width = occ_hi - occ_lo                                    # (..., 4)
    new_a_lo = index.first_row[:4] + occ_lo
    new_a_hi = new_a_lo + width

    # other side: '$' + smaller-char counts ('$' = total - char widths)
    d = (a_hi - a_lo) - jnp.sum(width, axis=-1)
    cum_w = jnp.cumsum(width, axis=-1) - width
    new_b_lo = b_lo[..., None] + d[..., None] + cum_w
    new_b_hi = new_b_lo + width

    # ---- active-side run hints via LF of the first/last c-run touched ----
    # first c-position >= a_lo sits in run_lo itself (if it is a c-run) or
    # in next_run_of_c; symmetric for the last c-position < a_hi.
    run_p = jnp.where(char_lo[..., None] == cvec, a_run_lo[..., None],
                      row_lo[..., NEXT0:NEXT0 + 4].astype(jnp.int32))
    run_q = jnp.where(char_hi[..., None] == cvec, a_run_hi1[..., None],
                      row_hi[..., PREV0:PREV0 + 4].astype(jnp.int32))
    run_p = jnp.clip(run_p, 0, None)
    run_q = jnp.clip(run_q, 0, None)
    row_p = index.fused[off_a[..., None] + run_p]   # (..., 4, NCOLS)
    row_q = index.fused[off_a[..., None] + run_q]
    hint_lo0 = row_p[..., LF_RUN].astype(jnp.int32)
    hint_hi0 = row_q[..., LF_RUN].astype(jnp.int32)

    ok = width > 0
    # fast-forward all hints in one batch: (..., 4, 4) =
    # [active lo fwd, active hi fwd, other lo fwd, other hi back]
    ffo = jnp.stack([
        jnp.broadcast_to(off_a[..., None], ok.shape),
        jnp.broadcast_to(off_a[..., None], ok.shape),
        jnp.broadcast_to(off_b[..., None], ok.shape),
    ], axis=-1)
    ffr = jnp.stack([
        hint_lo0, hint_hi0,
        jnp.broadcast_to(b_run_lo[..., None], ok.shape),
    ], axis=-1)
    ffp = jnp.stack([
        new_a_lo, new_a_hi - 1, new_b_lo,
    ], axis=-1)
    # dead children: freeze at (run 0, pos 0) so loops take no iterations
    okx = ok[..., None]
    ffo = jnp.where(okx, ffo, 0)
    ffr = jnp.where(okx, jnp.clip(ffr, 0, None), 0)
    ffp = jnp.where(okx, ffp, 0)
    ffr = _ff_forward(index, ffo, ffr, ffp)

    hb_run = jnp.where(ok, jnp.broadcast_to(b_run_hi1[..., None], ok.shape), 0)
    hb_off = jnp.where(ok, jnp.broadcast_to(off_b[..., None], ok.shape), 0)
    hb_pos = jnp.where(ok, new_b_hi - 1, jnp.uint32(0))
    hb_run = _ff_backward(index, hb_off, jnp.clip(hb_run, 0, None), hb_pos)

    new_a_rlo, new_a_rhi1 = ffr[..., 0], ffr[..., 1]
    new_b_rlo, new_b_rhi1 = ffr[..., 2], hb_run

    z = jnp.zeros_like(new_a_lo)
    sel = lambda x, y: jnp.where(bwd[..., None], x, y)
    u32 = lambda x: x.astype(jnp.uint32)
    cols = [
        sel(new_a_lo, new_b_lo), sel(new_a_hi, new_b_hi),
        sel(new_b_lo, new_a_lo), sel(new_b_hi, new_a_hi),
        u32(sel(new_a_rlo, new_b_rlo)), u32(sel(new_a_rhi1, new_b_rhi1)),
        u32(sel(new_b_rlo, new_a_rlo)), u32(sel(new_b_rhi1, new_a_rhi1)),
    ]

    if ranges.shape[-1] >= 12:
        # ---- textless toehold maintenance (reference: src/bmove/
        # bmove.cpp:289-444 SARangeBackwards/computeToehold[Rev]) ----
        # Lane cols 8..10: [toe_value, toe_offset, toe_flag]. toe_value is
        # a fwd-TEXT position: extent START when flag==0 (anchored in the
        # fwd table) or extent END when flag==1 (anchored in the rev
        # table); toe_offset = the anchored row's 0-based offset within
        # that side's interval. All update data rides in rows already
        # gathered for the extension itself.
        tv = ranges[..., 8]
        toff = ranges[..., 9]
        tflag = ranges[..., 10]
        n = index.n_arr[0]
        # width preserved (all parent occurrences extend by c): the anchor
        # survives; start -1 on prepend, end +1 on append
        parent_w = (a_hi - a_lo)[..., None]
        preserved = width == parent_w
        tv_pres = jnp.where(bwd, tv - jnp.where(tflag == 0, 1, 0),
                            tv + jnp.where(tflag == 1, 1, 0))[..., None]
        # reset from the queried side's run samples: last c-row in the
        # parent interval is hi-1 itself (its run head == c; use that
        # run's FIRST-row sample, in range because the interval spans >=2
        # runs on this branch) or the previous c-run's LAST row
        sample_q = jnp.where(
            char_hi[..., None] == cvec,
            jnp.broadcast_to(row_hi[..., SA_FIRST:SA_FIRST + 1],
                             width.shape),
            row_q[..., SA_LAST],
        )
        # anchored row's LF image, relative to the child's active-side lo
        # (per char c the cum count OF c in c's own candidate run)
        cum_hi_c = jnp.stack([row_hi[..., CUM0 + c] for c in range(4)],
                             axis=-1)
        cum_q_c = jnp.stack([row_q[..., c, CUM0 + c] for c in range(4)],
                            axis=-1)
        lf_rs = jnp.where(
            char_hi[..., None] == cvec,
            cum_hi_c,
            cum_q_c + (row_q[..., END] - row_q[..., START] - 1),
        )
        off_reset = (index.first_row[:4] + lf_rs) - new_a_lo
        tv_reset = jnp.where(bwd[..., None], sample_q - 1, n - sample_q)
        flag_reset = jnp.where(bwd[..., None], jnp.uint32(0),
                               jnp.uint32(1))
        cols += [
            jnp.where(preserved, tv_pres, tv_reset),
            jnp.where(preserved, toff[..., None], off_reset),
            jnp.where(preserved, tflag[..., None], flag_reset),
            jnp.zeros_like(width),
        ]

    out = jnp.stack(cols, axis=-1)                   # (..., 4, 8 or 12)
    return jnp.where(ok[..., None], out, z[..., None])


def extend_char(
    index: BMoveIndex, ranges: jax.Array, chars: jax.Array, dirs: jax.Array
) -> jax.Array:
    """Extend every node by its own single character (exact matching)."""
    all4 = extend_all(index, ranges, dirs)  # (..., 4, 8)
    safe = jnp.clip(chars, 0, 3).astype(jnp.int32)
    child = jnp.take_along_axis(
        all4, safe[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]
    bad = (chars > 3)[..., None]
    return jnp.where(bad, jnp.zeros_like(child), child)
