"""File-backed stores.

A copy of kvmatch_tpu/storage/file.py over the port's index structure; the
files either package writes are byte-identical.

* ``TimeSeriesFileStore`` reads/writes the reference's data file format: a raw
  stream of big-endian float64 values, conceptually grouped in 1000-point rows
  (TimeSeriesNode.java:28-66, TimeSeriesFileOperator.java:36-112) — the grouping
  has no on-disk framing, so the file is just ``n`` doubles.  A ``.npy`` fast path
  is also supported.

* ``IndexFileStore`` writes one file per scale using the reference's layout
  (IndexFileOperator.java:127-164):

      [row 0: key f64 BE + compact positions] ... [row R-1]
      [statisticInfo: (key f64, cum_intervals i32, cum_offsets i32) * R]
      [offset table: i32 BE * (R + 2)]
      [offset-of-offset-table: i32 BE]

  so an index built here is byte-layout-compatible in structure with the
  reference's local-file indexes (positions differ by the 0-based convention).

* ``IndexNpzStore``: one ``.npz`` of flat arrays, the fast path.

What the port adds: ``save`` takes a full device build's pieces to the host
first (``IndexScale.materialize_host``) and raises ``ValueError`` on a
stats-only index, which has no positions to save; ``load`` raises on a
series of more than 2^31 - 1 points, whose positions the port's builds and
device views (int32) cannot hold.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np

from ..index.device_build import MAX_POSITIONS
from ..index.structure import Index, IndexScale
from ..utils import codec


def _host_scales(index: Index) -> None:
    """Take every scale's intervals to the host; a stats-only scale raises
    before anything is written."""
    for w, sc in index.items():
        if sc.stats_only:
            raise ValueError(
                f"scale w={w} is stats-only (build_index_device_stats): it "
                f"holds no positions to save; build the index with "
                f"build_index_device, build_index_device_buckets or "
                f"build_index_host")
    for sc in index.values():
        sc.materialize_host()


def _check_n(n: int) -> int:
    if n > MAX_POSITIONS:
        raise ValueError(f"index of n={n} points: the port holds positions "
                         f"as int32 (at most {MAX_POSITIONS})")
    return n


class TimeSeriesFileStore:
    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._mm = None

    def _array(self) -> np.ndarray:
        if self._mm is None:
            if self.path.suffix == ".npy":
                self._mm = np.load(self.path, mmap_mode="r")
            else:
                self._mm = np.memmap(self.path, dtype=">f8", mode="r")
        return self._mm

    def read(self, left: int, length: int) -> np.ndarray:
        arr = self._array()
        if left < 0 or left + length > arr.size:
            raise ValueError(f"read out of range: left={left} length={length}")
        return np.asarray(arr[left:left + length], np.float64)

    def read_all(self) -> np.ndarray:
        return np.asarray(self._array(), np.float64)

    def length(self) -> int:
        return int(self._array().size)

    @staticmethod
    def write(path: str | os.PathLike, data: np.ndarray) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".npy":
            np.save(path, np.asarray(data, np.float64))
        else:
            np.asarray(data, ">f8").tofile(path)


class IndexFileStore:
    """One file per scale: ``index-{n}-{w}`` in a directory (IndexFileOperator.java:45)."""

    def __init__(self, directory: str | os.PathLike, n: int,
                 pos_bytes: int = 4):
        self.dir = Path(directory)
        self.n = n
        # 4-byte positions: the port's builds hold at most 2^31 - 1 points
        # (``_check_n``).  ``pos_bytes=8`` reads and writes the Long variant
        # (LongIndexNode codec) of files the JAX package wrote past that.
        self.pos_bytes = pos_bytes

    def _path(self, w: int) -> Path:
        return self.dir / f"index-{self.n}-{w}"

    def save(self, index: Index) -> None:
        _host_scales(index)
        self.dir.mkdir(parents=True, exist_ok=True)
        for w, sc in index.items():
            self._save_scale(self._path(w), sc)

    def _save_scale(self, path: Path, sc: IndexScale) -> None:
        offsets = []
        chunks = []
        pos = 0
        left, right, row_ptr = sc.left, sc.right, sc.row_ptr
        for r in range(sc.num_rows):
            a, b = int(row_ptr[r]), int(row_ptr[r + 1])
            row = np.array([sc.keys[r]], ">f8").tobytes() + \
                codec.encode_positions_compact(left[a:b], right[a:b],
                                               pos_bytes=self.pos_bytes)
            offsets.append(pos)
            chunks.append(row)
            pos += len(row)
        stat = codec.encode_statistic_info(sc.keys, sc.cum_intervals, sc.cum_offsets)
        offsets.append(pos)
        chunks.append(stat)
        pos += len(stat)
        offsets.append(pos)
        chunks.append(codec.encode_int_list(np.asarray(offsets)))
        with open(path, "wb") as f:
            f.write(b"".join(chunks))

    def load(self) -> Index:
        _check_n(self.n)
        index: Index = {}
        for path in sorted(self.dir.glob(f"index-{self.n}-*")):
            w = int(path.name.rsplit("-", 1)[1])
            index[w] = self._load_scale(path, w)
        return index

    def _load_scale(self, path: Path, w: int) -> IndexScale:
        blob = path.read_bytes()
        # Footer: last 4 bytes point at the offset table (readOffsetInfo,
        # IndexFileOperator.java:52-62).
        off_start = int(np.frombuffer(blob[-4:], ">i4")[0])
        offsets = codec.decode_int_list(blob[off_start:])
        n_rows = offsets.size - 2
        keys = np.empty(n_rows, np.float64)
        lefts, rights, row_ptr = [], [], np.zeros(n_rows + 1, np.int64)
        for r in range(n_rows):
            s, e = int(offsets[r]), int(offsets[r + 1])
            keys[r] = np.frombuffer(blob[s:s + 8], ">f8")[0]
            l, rr = codec.decode_positions_compact(blob[s + 8:e],
                                                   pos_bytes=self.pos_bytes)
            lefts.append(l)
            rights.append(rr)
            row_ptr[r + 1] = row_ptr[r] + l.size
        sk, ci, co = codec.decode_statistic_info(blob[int(offsets[-2]):off_start])
        left = np.concatenate(lefts) if lefts else np.empty(0, np.int64)
        right = np.concatenate(rights) if rights else np.empty(0, np.int64)
        # The reference layout carries no global mean bound; +inf is sound (the
        # engines' bound tracks degrade gracefully, see engine/norm_ed.py).
        upper = float("inf")
        return IndexScale(w=w, n=self.n, keys=keys, row_ptr=row_ptr,
                          left=left, right=right, cum_intervals=ci, cum_offsets=co,
                          mean_upper_bound=upper)


class IndexNpzStore:
    """Fast native persistence: one ``.npz`` with all scales (flat arrays)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)

    def save(self, index: Index) -> None:
        _host_scales(index)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload: Dict[str, np.ndarray] = {}
        for w, sc in index.items():
            p = f"w{w}_"
            payload[p + "keys"] = sc.keys
            payload[p + "row_ptr"] = sc.row_ptr
            payload[p + "left"] = sc.left
            payload[p + "right"] = sc.right
            payload[p + "cum_intervals"] = sc.cum_intervals
            payload[p + "cum_offsets"] = sc.cum_offsets
            payload[p + "meta"] = np.array([sc.n, sc.w], np.int64)
            payload[p + "upper"] = np.array([sc.mean_upper_bound])
        # Uncompressed: this is the FAST path (the reference-layout
        # IndexFileStore with the compact interval codec is the small one).
        np.savez(self.path, **payload)

    def load(self) -> Index:
        z = np.load(self.path)
        ws = sorted({int(k[1:].split("_")[0]) for k in z.files})
        index: Index = {}
        for w in ws:
            p = f"w{w}_"
            n, _ = z[p + "meta"]
            index[w] = IndexScale(
                w=w, n=_check_n(int(n)), keys=z[p + "keys"],
                row_ptr=z[p + "row_ptr"],
                left=z[p + "left"], right=z[p + "right"],
                cum_intervals=z[p + "cum_intervals"], cum_offsets=z[p + "cum_offsets"],
                mean_upper_bound=float(z[p + "upper"][0]))
        return index
