"""Byte codecs for index rows and meta tables.

A copy of kvmatch_tpu/utils/codec.py (pure NumPy; the port imports nothing
of the JAX package): the encoders give the same bytes.  Binary-compatible
re-implementation of the reference's serialization layer:

* ``encode_positions_compact`` / ``decode_positions_compact`` — the packed
  interval codec of IndexNode (IndexNode.java:51-128):
  ``{left:int32 BE}{count:byte}{diff bytes...}`` where each diff byte stores
  (value - 128) and a packed group holds 2*count+1 diffs after the 4-byte left.
* ``encode_statistic_info`` / ``decode_statistic_info`` — the meta-table triple
  codec which *cumulative-sums counts in place* during encoding
  (ByteUtils.java:86-121): rows are (key: f64 BE, cum_intervals: i32 BE,
  cum_offsets: i32 BE).
* int/long list codecs (ByteUtils.java:32-77).

These exist for persistence parity (the index file layout of
operator/file/IndexFileOperator.java) and for the memory-budget comparison against
the reference's compact on-disk size.  Vectorized NumPy, no Python byte loops.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def encode_positions_compact(left: np.ndarray, right: np.ndarray,
                             maximum_diff: int = 256,
                             pos_bytes: int = 4) -> bytes:
    """Pack sorted disjoint intervals like IndexNode.toBytesCompact
    (IndexNode.java:51-95); ``pos_bytes=8`` gives the int64 Long variant
    (mapreduce/common/LongIndexNode.java:35-191) for series beyond 2^31 points.

    Groups break when the gap to the previous interval >= maximum_diff or when a
    group reaches its count-byte capacity (count stored as (pairs-1)/2 biased).
    All widths/gaps must be < maximum_diff (guaranteed by the builder's cap).
    """
    k = left.size
    if k == 0:
        return b""
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    width = right - left
    gap = np.empty(k, np.int64)
    gap[0] = maximum_diff  # force a group start
    gap[1:] = left[1:] - right[:-1]
    # A group restarts when gap >= maximum_diff or the group already holds
    # the maximum number of follower pairs: (count-1)/2 + 2 < maximum_diff
    # with count = 2*followers + 1  =>  followers < maximum_diff - 1.
    max_followers = maximum_diff - 2
    # Group capacity is enforced inside each gap-delimited run (vectorized: runs
    # are found first, then capacity splits fall on fixed strides within runs).
    gap_break = gap >= maximum_diff
    run_id = np.cumsum(gap_break) - 1
    run_first = np.full(int(run_id[-1]) + 1, k, np.int64)
    np.minimum.at(run_first, run_id, np.arange(k))
    within = np.arange(k) - run_first[run_id]
    starts = gap_break | (within % (max_followers + 1) == 0)
    group_id = np.cumsum(starts) - 1
    n_groups = int(group_id[-1]) + 1
    first_idx = np.flatnonzero(starts)
    followers = np.diff(np.append(first_idx, k)) - 1

    hdr = pos_bytes + 2  # left + count byte + first width byte
    out_len = int(n_groups * hdr + followers.sum() * 2)
    buf = np.zeros(out_len, np.uint8)
    # Byte offset of each group.
    group_off = np.concatenate(([0], np.cumsum(hdr + 2 * followers)[:-1])).astype(np.int64)
    lefts = left[first_idx].astype(">i4" if pos_bytes == 4 else ">i8")
    lb = lefts.view(np.uint8).reshape(-1, pos_bytes)
    for b in range(pos_bytes):
        buf[group_off + b] = lb[:, b]
    buf[group_off + pos_bytes] = (followers - 128).astype(np.int64).astype(np.uint8)
    buf[group_off + pos_bytes + 1] = (width[first_idx] - 128).astype(np.int64).astype(np.uint8)
    # Follower diffs: per interval i not a start: gap-128, width-128.
    fmask = ~starts
    fidx = np.flatnonzero(fmask)
    if fidx.size:
        pos_within = np.arange(k) - first_idx[group_id]
        byte_pos = group_off[group_id[fidx]] + hdr + (pos_within[fidx] - 1) * 2
        buf[byte_pos] = (gap[fidx] - 128).astype(np.int64).astype(np.uint8)
        buf[byte_pos + 1] = (width[fidx] - 128).astype(np.int64).astype(np.uint8)
    return buf.tobytes()


def decode_positions_compact(data: bytes, pos_bytes: int = 4
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of encode_positions_compact (IndexNode.parseBytesCompact,
    IndexNode.java:110-129; LongIndexNode for pos_bytes=8)."""
    raw = np.frombuffer(data, np.uint8)
    lefts: List[np.ndarray] = []
    rights: List[np.ndarray] = []
    idx = 0
    n = raw.size
    dt = ">i4" if pos_bytes == 4 else ">i8"
    signed = raw.view(np.int8)  # Java bytes are signed; stored value = x - 128
    while idx < n:
        left0 = int(raw[idx: idx + pos_bytes].copy().view(dt)[0])
        followers = int(signed[idx + pos_bytes]) + 128
        width0 = int(signed[idx + pos_bytes + 1]) + 128
        idx += pos_bytes + 2
        diffs = signed[idx: idx + 2 * followers].astype(np.int64) + 128
        idx += 2 * followers
        gaps = diffs[0::2]
        widths = diffs[1::2]
        l = np.empty(followers + 1, np.int64)
        r = np.empty(followers + 1, np.int64)
        l[0], r[0] = left0, left0 + width0
        if followers:
            steps = gaps + widths
            r[1:] = r[0] + np.cumsum(steps)
            l[1:] = r[1:] - widths
        lefts.append(l)
        rights.append(r)
    if not lefts:
        e = np.empty(0, np.int64)
        return e, e
    return np.concatenate(lefts), np.concatenate(rights)


def encode_statistic_info(keys: np.ndarray, cum_intervals: np.ndarray,
                          cum_offsets: np.ndarray) -> bytes:
    """Meta-table rows (key f64, cum counts i32), already prefix-summed — the
    in-place cumulative trick of ByteUtils.listTripleToByteArray
    (ByteUtils.java:86-99)."""
    rec = np.zeros(keys.size, dtype=[("k", ">f8"), ("i", ">i4"), ("o", ">i4")])
    rec["k"] = keys
    rec["i"] = cum_intervals
    rec["o"] = cum_offsets
    return rec.tobytes()


def decode_statistic_info(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rec = np.frombuffer(data, dtype=[("k", ">f8"), ("i", ">i4"), ("o", ">i4")])
    return (rec["k"].astype(np.float64), rec["i"].astype(np.int64),
            rec["o"].astype(np.int64))


def encode_int_list(values: np.ndarray) -> bytes:
    return np.asarray(values, ">i4").tobytes()


def decode_int_list(data: bytes) -> np.ndarray:
    return np.frombuffer(data, ">i4").astype(np.int64)


def encode_long_list(values: np.ndarray) -> bytes:
    return np.asarray(values, ">i8").tobytes()


def decode_long_list(data: bytes) -> np.ndarray:
    return np.frombuffer(data, ">i8").astype(np.int64)
