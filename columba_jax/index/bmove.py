"""Run-length-compressed bidirectional move-structure index (b-move, RLC).

Batched re-design of the reference's BMove back-end
(reference: src/bmove/bmove.{h,cpp}, src/bmove/moverepr.{h,cpp}): the
BWT is represented by its maximal equal-character runs; LF is an O(1)
table step plus a short fast-forward, so index size scales with the number
of runs r instead of the text length n.

Differences from the reference, by design (batch-first, not a port):

* One **fused row per run interval** (start/end, LF destination pos+run,
  char, SA samples at head and tail, next/previous run of each character,
  per-character cumulative counts) so a single 80-byte row gather serves a
  whole endpoint query; the reference scatters this state over separate
  bit-packed structures (moverepr.h) walked pointer-by-pointer.
* "Walk to the next run of c" (reference moverepr.cpp:313-330) becomes a
  precomputed per-run table lookup -- O(r) extra ints buy away the only
  data-dependent loop in the hot path.
* Locate is a batched LF-walk to the nearest SA sample, where samples sit
  at every run boundary (the reference's .smpf/.smpl) AND at every
  LOCATE_STRIDE-th BWT row, so every walk is bounded by LOCATE_STRIDE
  steps regardless of run length. The reference instead enumerates
  occurrences by a sequential toehold + phi-walk bounded by PLCP
  (bmove.cpp:503-547, plcp.h:59-130) — a pointer chase over the occurrence
  list, the exact shape a lockstep batch cannot run; bounded per-row LF-walks are
  uniform lanes. Cost: n/16 bytes of samples on top of the n/4-byte text.
* The packed 2-bit text is kept (0.25 B/base) so the in-text verification
  and CIGAR paths are shared with the Vanilla back-end; the reference's
  textless matchedStr machinery (indexinterface.h:294-304) exists to save
  that memory and costs per-node string state -- hostile to a frontier
  executor. Text can be dropped for very large pan-genomes at the cost of
  in-index-only completion (distances from colMin sums, no CIGAR).

State convention: a frontier node's range vector widens from 4 to 8 ints:
``[f_lo, f_hi, r_lo, r_hi, f_run_lo, f_run_hi1, r_run_lo, r_run_hi1]``
where *_run_lo is the run interval containing *_lo and *_run_hi1 the one
containing *_hi - 1 (run hints; local to each direction's table).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.index.build import (
    IndexArrays, INDEX_FORMAT_VERSION, pack_2bit, preprocess_fasta,
)
from columba_jax.index.suffix import suffix_array

# fused row column indices
START, END, LF_POS, LF_RUN, CHAR, SA_FIRST, SA_LAST = 0, 1, 2, 3, 4, 5, 6
NEXT0, PREV0, CUM0 = 8, 12, 16
NCOLS = 20

# stride of the in-run SA sampling (power of two). Run-boundary samples
# alone make locate walk an expected (run length)/2 LF steps — degenerate
# on pan-genomes where RLC's r << n means huge runs; sampling every
# LOCATE_STRIDE-th BWT row bounds every walk at LOCATE_STRIDE steps for
# n/16 bytes (the RLC flavor already keeps the n/4-byte packed text for
# verification, see the module docstring; the reference instead pays a
# phi/PLCP structure + sequential enumeration, src/bmove/plcp.h:59-130,
# bmove.cpp:503-547).
LOCATE_STRIDE = 64


def _phi_tables(sa_full: np.ndarray, bounds: np.ndarray):
    """Piecewise phi / phi-inverse over run-boundary samples.

    phi(SA[i]) = SA[i-1] and phinv(SA[i]) = SA[i+1] are piecewise-linear
    with one piece per BWT run (the r-index property the reference's
    locate rests on, src/bmove/plcp.h:59-130): for each run-first row b,
    the piece [x, ...) with x = SA[b], y = SA[b-1] translates by (y - x).
    Returns (phi_x sorted, phi_y, phinv_x sorted, phinv_y), all uint32.
    Verified exactly against brute-force SA adjacency (test_bmove)."""
    x = sa_full[bounds]
    y = sa_full[bounds - 1]
    o = np.argsort(x)
    xi = sa_full[bounds - 1]
    yi = sa_full[bounds]
    oi = np.argsort(xi)
    return (x[o].astype(np.uint32), y[o].astype(np.uint32),
            xi[oi].astype(np.uint32), yi[oi].astype(np.uint32))


def _runs_of_direction(codes: np.ndarray, sa_method: str,
                       want_stride: bool = False,
                       want_phi: bool = False):
    """Move-table arrays for one direction. codes: clean 0..3 text."""
    n = len(codes)
    big = n + 1
    sa = suffix_array(codes, method=sa_method)
    sa_full = np.empty(big, dtype=np.int64)
    sa_full[0] = n
    sa_full[1:] = sa
    prev = sa_full - 1
    bwt5 = np.where(prev < 0, 4, codes[np.clip(prev, 0, n - 1)]).astype(np.uint8)

    # maximal runs
    bounds = np.flatnonzero(np.diff(bwt5.astype(np.int16))) + 1
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [big]]).astype(np.int64)
    R = len(starts)
    rchar = bwt5[starts].astype(np.int64)

    # per-char cumulative counts at run starts (occ_c(start), '$' excluded)
    cum = np.zeros((R, 4), dtype=np.int64)
    for c in range(4):
        lens_c = np.where(rchar == c, ends - starts, 0)
        cum[:, c] = np.concatenate([[0], np.cumsum(lens_c)[:-1]])

    # first F-column row per char, '$ACGT' order: '$'->0
    char_counts = np.bincount(codes, minlength=4).astype(np.int64)
    first = np.zeros(5, dtype=np.int64)
    first[4] = 0  # '$'
    first[0] = 1
    first[1:4] = 1 + np.cumsum(char_counts)[:3]

    lf_pos = first[rchar] + np.where(rchar < 4, cum[np.arange(R),
                                                    np.clip(rchar, 0, 3)], 0)
    lf_run = np.searchsorted(starts, lf_pos, side="right") - 1

    # next/prev run of char c
    nxt = np.full((R, 4), R, dtype=np.int64)
    prv = np.full((R, 4), -1, dtype=np.int64)
    for c in range(4):
        idx = np.flatnonzero(rchar == c)
        if len(idx):
            k = np.searchsorted(idx, np.arange(R), side="left")
            nxt[:, c] = np.where(k < len(idx), idx[np.clip(k, 0, len(idx) - 1)], R)
            k2 = np.searchsorted(idx, np.arange(R), side="right") - 1
            prv[:, c] = np.where(k2 >= 0, idx[np.clip(k2, 0, None)], -1)

    # positions/counts/SA values are uint32 (build.MAX_N ceiling); run
    # indices share the table and are bit-cast back to int32 on device
    # (PREV = -1 round-trips as 0xFFFFFFFF)
    fused = np.zeros((R + 1, NCOLS), dtype=np.uint32)
    fused[:R, START] = starts
    fused[:R, END] = ends
    fused[:R, LF_POS] = lf_pos
    fused[:R, LF_RUN] = lf_run
    fused[:R, CHAR] = rchar
    fused[:R, SA_FIRST] = sa_full[starts]
    fused[:R, SA_LAST] = sa_full[ends - 1]
    fused[:R, NEXT0:NEXT0 + 4] = nxt.astype(np.uint32)
    fused[:R, PREV0:PREV0 + 4] = prv.astype(np.uint32)
    fused[:R, CUM0:CUM0 + 4] = cum
    # sentinel row R: empty interval at big (fast-forward terminator)
    fused[R, START] = big
    fused[R, END] = big
    fused[R, CHAR] = 4
    fused[R, NEXT0:NEXT0 + 4] = R
    fused[R, PREV0:PREV0 + 4] = R - 1
    fused[R, CUM0:CUM0 + 4] = cum[R - 1] + np.where(
        rchar[R - 1] == np.arange(4), ends[R - 1] - starts[R - 1], 0)
    sa_stride = (sa_full[::LOCATE_STRIDE].astype(np.uint32)
                 if want_stride else None)
    phi = _phi_tables(sa_full, bounds) if want_phi else None
    return fused, first.astype(np.uint32), R, sa_stride, phi


@dataclass(frozen=True)
class BMoveArrays:
    """Host-side persisted arrays of one RLC index.

    Textless flavor (meta["textless"]): ``text`` and ``sa_stride`` are
    empty — index bytes scale with the RUN count r, not the text length n
    (the property that defines b-move, src/bmove/bmove.cpp:45-189).
    Locate then uses search-time toehold samples + the phi tables."""

    meta: dict
    fused_fwd: np.ndarray   # (R_f + 1, NCOLS) uint32
    fused_rev: np.ndarray   # (R_r + 1, NCOLS) uint32
    first_row: np.ndarray   # (5,) uint32: first F row per '$ACGT' char
    text: np.ndarray        # packed uint32 (2-bit); EMPTY when textless
    sa_stride: np.ndarray   # uint32 strided SA; EMPTY when textless
    seq_starts: np.ndarray
    seq_names: list
    # phi / phi-inverse piece tables (textless locate); empty otherwise
    phi_fwd: np.ndarray = None     # (P_f, 4): x_sorted, y, xinv, yinv
    phi_rev: np.ndarray = None

    @property
    def n(self) -> int:
        return self.meta["n"]

    @property
    def textless(self) -> bool:
        return bool(self.meta.get("textless", False))


def build_bmove_from_codes(
    codes: np.ndarray,
    seq_names=None,
    seq_starts=None,
    sa_method: str = "auto",
    textless: bool = False,
) -> BMoveArrays:
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.max(initial=0) > 3:
        raise ValueError("text contains non-ACGT codes; preprocess first")
    n = len(codes)
    from columba_jax.index.build import MAX_N

    if n > MAX_N:
        raise ValueError(
            f"text length {n} exceeds the uint32 index ceiling {MAX_N}")
    fused_fwd, first, r_f, sa_stride, phi_f = _runs_of_direction(
        codes, sa_method, want_stride=not textless, want_phi=textless)
    fused_rev, _, r_r, _, phi_r = _runs_of_direction(
        codes[::-1].copy(), sa_method, want_phi=textless)
    if seq_names is None:
        seq_names = ["seq0"]
        seq_starts = np.array([0, n], dtype=np.int64)
    meta = dict(
        format_version=INDEX_FORMAT_VERSION, flavor="rlc", n=n,
        runs_fwd=r_f, runs_rev=r_r, num_seqs=len(seq_names),
        locate_stride=LOCATE_STRIDE, textless=bool(textless),
    )
    e32 = np.zeros(0, dtype=np.uint32)
    return BMoveArrays(
        meta=meta, fused_fwd=fused_fwd, fused_rev=fused_rev,
        first_row=first,
        text=e32 if textless else pack_2bit(codes),
        sa_stride=e32 if textless else sa_stride,
        phi_fwd=(np.stack(phi_f, axis=1) if textless
                 else np.zeros((0, 4), np.uint32)),
        phi_rev=(np.stack(phi_r, axis=1) if textless
                 else np.zeros((0, 4), np.uint32)),
        seq_starts=np.asarray(seq_starts, dtype=np.int64),
        seq_names=list(seq_names),
    )


def build_bmove(fasta_paths, out_dir=None, seed=42, sa_method="auto",
                textless: bool = False):
    """FASTA file(s) -> RLC index arrays (optionally persisted)."""
    if isinstance(fasta_paths, str):
        fasta_paths = [fasta_paths]
    codes, names, starts = preprocess_fasta(fasta_paths, seed=seed)
    idx = build_bmove_from_codes(codes, names, starts, sa_method=sa_method,
                                 textless=textless)
    if out_dir is not None:
        save_bmove(idx, out_dir)
    return idx


_BM_FIELDS = ["fused_fwd", "fused_rev", "first_row", "text", "sa_stride",
              "seq_starts", "phi_fwd", "phi_rev"]


def save_bmove(idx: BMoveArrays, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in _BM_FIELDS:
        np.save(os.path.join(out_dir, name + ".npy"), getattr(idx, name))
    meta = dict(idx.meta)
    meta["seq_names"] = idx.seq_names
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_bmove(out_dir: str) -> BMoveArrays:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("flavor") != "rlc":
        raise ValueError("not an RLC index (flavor mismatch)")
    if meta.get("format_version") != INDEX_FORMAT_VERSION:
        raise ValueError("index format mismatch; rebuild")
    seq_names = meta.pop("seq_names")
    arrs = {}
    for name in _BM_FIELDS:
        path = os.path.join(out_dir, name + ".npy")
        if name in ("phi_fwd", "phi_rev") and not os.path.exists(path):
            # pre-textless index layout: no phi tables persisted
            arrs[name] = np.zeros((0, 4), np.uint32)
            continue
        try:
            arrs[name] = np.load(path)
        except FileNotFoundError as e:
            raise ValueError(
                f"RLC index at {out_dir} is missing {e.filename} "
                "(built by an older version?); rebuild it") from e
    return BMoveArrays(meta=meta, seq_names=seq_names, **arrs)


@dataclass(frozen=True)
class BMoveIndex:
    """Device-side RLC index (pytree of jnp arrays).

    The fwd and rev fused tables are concatenated so a mixed-direction
    frontier picks its table with a row offset, exactly like FMIndex's
    concatenated occ layout.
    """

    fused: jax.Array      # (R_f + R_r + 2, NCOLS) uint32
    first_row: jax.Array  # (5,) uint32
    text: jax.Array       # packed uint32 words (padded)
    sa_stride: jax.Array  # uint32 SA at every LOCATE_STRIDE-th fwd row
    n_arr: jax.Array      # (2,) uint32 [n, n+1]

    n: int = 0
    r_fwd: int = 0        # fwd intervals (rev table rows offset by r_fwd+1)
    r_rev: int = 0
    stride: int = LOCATE_STRIDE
    # textless flavor: lanes carry toehold samples (range_width 12); the
    # init sample is the full range's last row (reference
    # getInitialToehold, src/bmove/bmove.h:136-142)
    textless: bool = False
    toe_init: int = 0     # SA_fwd[n] = SA of the full fwd range's last row

    @staticmethod
    def from_arrays(arrays: BMoveArrays) -> "BMoveIndex":
        n = arrays.n
        # (rows, 128) word layout — matches FMIndex.text (verify's window
        # gathers assume 128-lane rows; see fmindex.py / ops/verify.py)
        tw = np.asarray(arrays.text, dtype=np.uint32)
        pad = (-len(tw)) % 128 + 128
        text = np.concatenate([tw, np.zeros(pad, np.uint32)]).reshape(-1,
                                                                      128)
        fused = np.concatenate([arrays.fused_fwd, arrays.fused_rev])
        r_f = arrays.meta["runs_fwd"]
        return BMoveIndex(
            fused=jax.device_put(np.asarray(fused, dtype=np.uint32)),
            first_row=jnp.asarray(
                np.asarray(arrays.first_row, dtype=np.uint32)),
            text=jax.device_put(text),
            sa_stride=jax.device_put(
                np.asarray(arrays.sa_stride, dtype=np.uint32)),
            n_arr=jnp.asarray(np.asarray([n, n + 1], dtype=np.uint32)),
            n=n,
            r_fwd=r_f,
            r_rev=arrays.meta["runs_rev"],
            stride=arrays.meta.get("locate_stride", LOCATE_STRIDE),
            textless=arrays.textless,
            toe_init=int(arrays.fused_fwd[r_f - 1, SA_LAST]),
        )

    @property
    def num_rows(self) -> int:
        return self.n + 1

    @property
    def range_width(self) -> int:
        # textless lanes append [toe_value, toe_offset, toe_flags, pad]
        return 12 if self.textless else 8

    def full_range(self, batch_shape=()) -> jax.Array:
        """Whole-index range pair + run hints (+ toehold when textless)."""
        big = self.n + 1
        cols = [0, big, 0, big, 0, self.r_fwd - 1, 0, self.r_rev - 1]
        if self.textless:
            # toehold: SA of last row (offset big-1), flag start, valid
            cols += [self.toe_init, big - 1, 0, 0]
        r = jnp.array(cols, dtype=jnp.uint32)
        return jnp.broadcast_to(r, (*batch_shape, len(cols)))


jax.tree_util.register_dataclass(
    BMoveIndex,
    data_fields=["fused", "first_row", "text", "sa_stride", "n_arr"],
    meta_fields=["n", "r_fwd", "r_rev", "stride", "textless", "toe_init"],
)
