"""Native (C++) SAM emission: the host-side throughput engine.

Round 2 measured that ~99% of end-to-end wall time was host-side Python —
dominated by the per-occurrence traceback DP and per-record SAM string
assembly. This module routes both through ``native/emit.cpp`` (banded DP +
CIGAR + line formatting, internally threaded, GIL released during the
call), with the occurrence bookkeeping done as vectorized numpy on
:class:`~columba_jax.search.pipeline.OccArray`.

The reference's analogue is the per-worker SAM generation inside the
thread pool (reference: src/indexhelpers.cpp:56-260 TextOcc SAM lines,
src/searchstrategy.cpp:1824-1902 generateOutputSingleEnd); here one native
call emits a whole batch.

Byte-parity with the pure-Python path (strategy.emit_sam) is enforced by
tests/test_emit_native.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from columba_jax import native

_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        lib = native.load("emit", ["emit.cpp"])
        if lib is not None:
            lib.emit_sam_se.restype = ctypes.c_int64
            lib.emit_sam_se.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # codes
                ctypes.c_void_p, ctypes.c_void_p,                 # names
                ctypes.c_void_p, ctypes.c_void_p,                 # quals
                ctypes.c_void_p, ctypes.c_void_p,                 # occ off/end
                ctypes.c_void_p, ctypes.c_void_p,                 # dist/strand
                ctypes.c_void_p,                                  # nbest_pre
                ctypes.c_void_p, ctypes.c_int64,                  # text
                ctypes.c_void_p, ctypes.c_int32,                  # seq_starts
                ctypes.c_void_p, ctypes.c_void_p,                 # seqnames
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,                                   # kb/xa/unm/cig
                ctypes.c_int32,                                   # n_threads
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # out
            ]
            if hasattr(lib, "emit_sam_pe"):
                lib.emit_sam_pe.restype = ctypes.c_int64
                lib.emit_sam_pe.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                    ctypes.c_int32,                                   # codes1
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # codes2
                    ctypes.c_void_p, ctypes.c_void_p,                 # names1
                    ctypes.c_void_p, ctypes.c_void_p,                 # quals1
                    ctypes.c_void_p, ctypes.c_void_p,                 # names2
                    ctypes.c_void_p, ctypes.c_void_p,                 # quals2
                    ctypes.c_void_p,                                  # pair_off
                    ctypes.c_void_p, ctypes.c_void_p,                 # end1/s1
                    ctypes.c_void_p, ctypes.c_void_p,                 # end2/s2
                    ctypes.c_void_p, ctypes.c_void_p,                 # tlen/mq
                    ctypes.c_void_p,                                  # proper
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u1
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u2
                    ctypes.c_void_p, ctypes.c_int64,                  # text
                    ctypes.c_void_p, ctypes.c_int32,                  # starts
                    ctypes.c_void_p, ctypes.c_void_p,                 # seqnames
                    ctypes.c_int32, ctypes.c_int32,                   # kb/thr
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # out
                ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def pack_strings(strings, encode: bool = True):
    """list of str/bytes -> (joined bytes, int64 offsets)."""
    bs = [s.encode() if encode and isinstance(s, str) else s
          for s in strings]
    offs = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return b"".join(bs), offs


class SeqNameCache:
    """Per-index cached seqname buffer + offsets for the native call."""

    def __init__(self, arrays):
        self.buf, self.offs = pack_strings(arrays.seq_names)
        self.starts = np.ascontiguousarray(arrays.seq_starts,
                                           dtype=np.int64)
        self.n_seqs = len(arrays.seq_names)


_SEQNAME_CACHE: dict = {}


def seqname_cache(arrays) -> SeqNameCache:
    key = id(arrays)
    ent = _SEQNAME_CACHE.get(key)
    if ent is None or ent[0] is not arrays:
        ent = (arrays, SeqNameCache(arrays))
        _SEQNAME_CACHE[key] = ent
    return ent[1]


def occ_groups(occs, n_reads: int):
    """Sort occurrences into emission order and group per read.

    Emission order within a read mirrors strategy.emit_sam's
    ``sorted(mr.occs, key=(distance, begin, strand))``. Returns
    (occ_off (R+1,) int64, end, dist, strand, nbest_pre (R,) int32).
    """
    order = np.lexsort((occs.strand, occs.begin, occs.distance,
                        occs.read_id))
    rid = occs.read_id[order]
    end = np.ascontiguousarray(occs.end[order], dtype=np.int64)
    dist = np.ascontiguousarray(occs.distance[order], dtype=np.int32)
    strand = np.ascontiguousarray(occs.strand[order], dtype=np.uint8)
    occ_off = np.searchsorted(rid, np.arange(n_reads + 1),
                              side="left").astype(np.int64)
    sizes = np.diff(occ_off)
    nbest = np.zeros(n_reads, dtype=np.int32)
    nz = sizes > 0
    if nz.any():
        best_per_read = np.zeros(n_reads, dtype=np.int64)
        best_per_read[nz] = dist[occ_off[:-1][nz]]
        is_best = dist == best_per_read[rid]
        nbest = np.bincount(rid[is_best],
                            minlength=n_reads).astype(np.int32)
    return occ_off, end, dist, strand, nbest


def emit_sam_native(
    codes: np.ndarray,
    names_buf: bytes, name_offs: np.ndarray,
    quals_buf: bytes, qual_offs: np.ndarray,
    occs,
    arrays,
    genome: np.ndarray,
    kb: int,
    xa_tag: bool = False,
    unmapped_records: bool = True,
    with_cigar: bool = True,
    n_threads: int = 3,
    counters=None,
) -> bytes | None:
    """Emit one batch of SE SAM records natively; None if lib unavailable.

    codes: (R, m) uint8 contiguous forward-strand reads; occs: OccArray
    with read_id in [0, R).
    """
    lib = _lib()
    if lib is None:
        return None
    R, m = codes.shape
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sn = seqname_cache(arrays)
    occ_off, end, dist, strand, nbest = occ_groups(occs, R)
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    qual_offs = np.ascontiguousarray(qual_offs, dtype=np.int64)

    n_occ = len(end)
    name_bytes_per_occ = int(
        (name_offs[1:] - name_offs[:-1])[occs.read_id].sum()) if n_occ else 0
    cap = (len(names_buf) + len(quals_buf) + R * (m + 64)
           + name_bytes_per_occ + n_occ * (2 * m + 4 * (2 * m + kb) + 128)
           + 1024)
    stats = np.zeros(4, dtype=np.int64)
    for _ in range(2):
        out = ctypes.create_string_buffer(cap)
        n = lib.emit_sam_se(
            codes.ctypes.data, R, m,
            names_buf, name_offs.ctypes.data,
            quals_buf, qual_offs.ctypes.data,
            occ_off.ctypes.data, end.ctypes.data,
            dist.ctypes.data, strand.ctypes.data,
            nbest.ctypes.data,
            genome.ctypes.data, genome.shape[0],
            sn.starts.ctypes.data, sn.n_seqs,
            sn.buf, sn.offs.ctypes.data,
            int(kb), int(bool(xa_tag)), int(bool(unmapped_records)),
            int(bool(with_cigar)), int(n_threads),
            out, cap, stats.ctypes.data,
        )
        if n >= 0:
            if counters is not None:
                counters.cigars_computed += int(stats[0])
            return out.raw[:n]
        cap = -n + 1024
    raise RuntimeError("emit_sam_se: buffer sizing failed twice")


def pe_available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "emit_sam_pe")


def pe_soa_from_mapped(mapped) -> dict:
    """MappedPair list -> SoA arrays for the native PE emitter.

    Candidate order, truncation (100/read) and MAPQ semantics mirror
    paired.emit_sam_paired exactly (reference PE SAM generation:
    src/searchstrategy.cpp:1904-1980); only the traceback + string
    assembly moves to native code.
    """
    from columba_jax.io import sam

    R = len(mapped)
    pair_off = np.zeros(R + 1, dtype=np.int64)
    end1, st1, end2, st2, tlen1, mqv = [], [], [], [], [], []
    proper = np.zeros(R, dtype=np.uint8)
    u_end = [np.full(R, -1, dtype=np.int64), np.full(R, -1, dtype=np.int64)]
    u_st = [np.zeros(R, dtype=np.uint8), np.zeros(R, dtype=np.uint8)]
    u_mq = [np.zeros(R, dtype=np.int32), np.zeros(R, dtype=np.int32)]
    for i, mp in enumerate(mapped):
        cands = mp.pairs or mp.discordant
        if cands:
            cands = sorted(cands,
                           key=lambda p: (p.total_distance, p.up.begin))
            proper[i] = 1 if mp.pairs else 0
            best = cands[0].total_distance
            n_best = sum(1 for p in cands if p.total_distance == best)
            mq = sam.mapq(n_best)
            for p in cands[:100]:
                o1 = p.up if p.up_is_read1 else p.down
                o2 = p.down if p.up_is_read1 else p.up
                end1.append(o1.end)
                st1.append(o1.strand)
                end2.append(o2.end)
                st2.append(o2.strand)
                t = p.down.end - p.up.begin
                tlen1.append(t if o1.begin <= o2.begin else -t)
                mqv.append(mq if p.total_distance == best else 0)
            pair_off[i + 1] = pair_off[i] + min(len(cands), 100)
        else:
            pair_off[i + 1] = pair_off[i]
            for side, occs in enumerate((mp.unpaired1, mp.unpaired2)):
                if occs:
                    o = min(occs, key=lambda o: (o.distance, o.begin))
                    u_end[side][i] = o.end
                    u_st[side][i] = o.strand
                    u_mq[side][i] = sam.mapq(
                        sum(1 for t in occs if t.distance == o.distance))
    return dict(
        pair_off=pair_off,
        end1=np.array(end1, dtype=np.int64),
        st1=np.array(st1, dtype=np.uint8),
        end2=np.array(end2, dtype=np.int64),
        st2=np.array(st2, dtype=np.uint8),
        tlen1=np.array(tlen1, dtype=np.int64),
        mq=np.array(mqv, dtype=np.int32),
        proper=proper,
        u_end1=u_end[0], u_st1=u_st[0], u_mq1=u_mq[0],
        u_end2=u_end[1], u_st2=u_st[1], u_mq2=u_mq[1],
    )


def _buf_arg(b):
    """bytes -> itself (ctypes keeps it alive); ndarray -> data pointer."""
    return b if isinstance(b, bytes) else b.ctypes.data


def pe_soa_from_rows(res, lo: int, hi: int) -> dict:
    """PERowsBest read-range [lo, hi) -> SoA for the native PE emitter,
    fully vectorized (the array-native replacement of pe_soa_from_mapped:
    same candidate order — rows arrive sorted (pair_id, total, u_begin) —
    same 100/read truncation and MAPQ semantics)."""
    from columba_jax.search.paired import _mapq_vec

    rows = res.rows
    n = hi - lo
    r0 = int(np.searchsorted(rows.pair_id, lo, side="left"))
    r1 = int(np.searchsorted(rows.pair_id, hi, side="left"))
    pid = rows.pair_id[r0:r1] - lo
    u_isl = rows.up_is_1[r0:r1].astype(bool)
    u_end = rows.u_end[r0:r1]
    u_beg = rows.u_begin[r0:r1]
    u_str = rows.u_strand[r0:r1]
    d_end = rows.d_end[r0:r1]
    d_beg = rows.d_begin[r0:r1]
    d_str = rows.d_strand[r0:r1]
    tot = rows.u_dist[r0:r1] + rows.d_dist[r0:r1]
    bounds = np.searchsorted(pid, np.arange(n + 1))
    has = bounds[1:] > bounds[:-1]
    best = np.zeros(n, dtype=np.int64)
    best[has] = tot[bounds[:-1][has]]       # first row per read = best
    is_best = tot == best[pid]
    nb = np.bincount(pid[is_best], minlength=n)
    mq_read = np.zeros(n, dtype=np.int32)
    mq_read[has] = _mapq_vec(nb[has])
    mqi = np.where(is_best, mq_read[pid], 0).astype(np.int32)
    end1 = np.where(u_isl, u_end, d_end)
    st1 = np.where(u_isl, u_str, d_str).astype(np.uint8)
    end2 = np.where(u_isl, d_end, u_end)
    st2 = np.where(u_isl, d_str, u_str).astype(np.uint8)
    o1_beg = np.where(u_isl, u_beg, d_beg)
    o2_beg = np.where(u_isl, d_beg, u_beg)
    t = d_end - u_beg
    tlen1 = np.where(o1_beg <= o2_beg, t, -t).astype(np.int64)
    rank = np.arange(len(pid)) - bounds[:-1][pid]
    keep = rank < 100
    pair_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.minimum(np.diff(bounds), 100), out=pair_off[1:])
    c = np.ascontiguousarray
    return dict(
        pair_off=pair_off,
        end1=c(end1[keep], dtype=np.int64), st1=c(st1[keep]),
        end2=c(end2[keep], dtype=np.int64), st2=c(st2[keep]),
        tlen1=c(tlen1[keep]), mq=c(mqi[keep]),
        proper=has.astype(np.uint8),        # rows mode: no discordant
        u_end1=c(res.u_end1[lo:hi]), u_st1=c(res.u_st1[lo:hi]),
        u_mq1=c(res.u_mq1[lo:hi]),
        u_end2=c(res.u_end2[lo:hi]), u_st2=c(res.u_st2[lo:hi]),
        u_mq2=c(res.u_mq2[lo:hi]),
    )


def emit_sam_pe_native(
    recs1, recs2, mapped, arrays, genome: np.ndarray, kb: int,
    n_threads: int = 3, counters=None,
) -> bytes | None:
    """Emit one same-shape run of PE SAM records natively; None if the
    native lib is unavailable (caller falls back to the Python emitter)."""
    if not pe_available():
        return None
    codes1 = np.ascontiguousarray(np.stack([r.codes for r in recs1]),
                                  dtype=np.uint8)
    codes2 = np.ascontiguousarray(np.stack([r.codes for r in recs2]),
                                  dtype=np.uint8)
    names1, n1off = pack_strings([r.name for r in recs1])
    quals1, q1off = pack_strings([r.qual for r in recs1])
    names2, n2off = pack_strings([r.name for r in recs2])
    quals2, q2off = pack_strings([r.qual for r in recs2])
    return emit_sam_pe_soa(
        codes1, names1, n1off, quals1, q1off,
        codes2, names2, n2off, quals2, q2off,
        pe_soa_from_mapped(mapped), arrays, genome, kb,
        n_threads=n_threads, counters=counters)


def _codes_arg(codes, s_off):
    """codes as (R, m) matrix or (flat buffer, offsets): -> (buf, offs, R, m)."""
    if s_off is None:
        R, m = codes.shape
        offs = np.arange(R + 1, dtype=np.int64) * m
        return np.ascontiguousarray(codes, dtype=np.uint8), offs, R, m
    offs = np.ascontiguousarray(s_off, dtype=np.int64)
    R = len(offs) - 1
    m = int(offs[1] - offs[0]) if R else 0
    return codes, offs, R, m


def emit_sam_pe_soa(
    codes1: np.ndarray, names1, n1off: np.ndarray, quals1,
    q1off: np.ndarray,
    codes2: np.ndarray, names2, n2off: np.ndarray, quals2,
    q2off: np.ndarray,
    soa: dict, arrays, genome: np.ndarray, kb: int,
    n_threads: int = 3, counters=None,
    seq_offs1=None, seq_offs2=None,
) -> bytes:
    """SoA-level PE emission: read codes as (R, m) matrices OR flat
    parser buffers with absolute offsets (seq_offs1/2); name/qual buffers
    likewise carry absolute per-record offsets, so chunk-parser slices
    pass through without copying or gathering."""
    lib = _lib()
    codes1, s1off, R, m1 = _codes_arg(codes1, seq_offs1)
    codes2, s2off, _, m2 = _codes_arg(codes2, seq_offs2)
    n1off = np.ascontiguousarray(n1off, dtype=np.int64)
    q1off = np.ascontiguousarray(q1off, dtype=np.int64)
    n2off = np.ascontiguousarray(n2off, dtype=np.int64)
    q2off = np.ascontiguousarray(q2off, dtype=np.int64)
    sn = seqname_cache(arrays)
    P = len(soa["end1"])
    mmax = max(m1, m2)
    line = 4 * (mmax + kb) + 64 + 96
    name_max = max(int((n1off[1:] - n1off[:-1]).max(initial=0)),
                   int((n2off[1:] - n2off[:-1]).max(initial=0)))
    cap = (2 * P + 2 * R) * (line + name_max) + 4096
    stats = np.zeros(4, dtype=np.int64)
    for _ in range(2):
        out = ctypes.create_string_buffer(cap)
        n = lib.emit_sam_pe(
            codes1.ctypes.data, s1off.ctypes.data, R, m1,
            codes2.ctypes.data, s2off.ctypes.data, m2,
            _buf_arg(names1), n1off.ctypes.data,
            _buf_arg(quals1), q1off.ctypes.data,
            _buf_arg(names2), n2off.ctypes.data,
            _buf_arg(quals2), q2off.ctypes.data,
            soa["pair_off"].ctypes.data,
            soa["end1"].ctypes.data, soa["st1"].ctypes.data,
            soa["end2"].ctypes.data, soa["st2"].ctypes.data,
            soa["tlen1"].ctypes.data, soa["mq"].ctypes.data,
            soa["proper"].ctypes.data,
            soa["u_end1"].ctypes.data, soa["u_st1"].ctypes.data,
            soa["u_mq1"].ctypes.data,
            soa["u_end2"].ctypes.data, soa["u_st2"].ctypes.data,
            soa["u_mq2"].ctypes.data,
            genome.ctypes.data, genome.shape[0],
            sn.starts.ctypes.data, sn.n_seqs,
            sn.buf, sn.offs.ctypes.data,
            int(kb), int(n_threads),
            out, cap, stats.ctypes.data,
        )
        if n >= 0:
            if counters is not None:
                counters.cigars_computed += int(stats[0])
            return out.raw[:n]
        cap = -n + 1024
    raise RuntimeError("emit_sam_pe: buffer sizing failed twice")
