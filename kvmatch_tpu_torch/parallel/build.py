"""Sharded index build: halo exchange and the per-shard bucket pass (port
of kvmatch_tpu/parallel/build.py).

Each shard owns an equal slice of window starts.  Its bucket pass runs on
its own device over the slice plus the first ``max(scales) - 1`` points of
the next shard (the last shard takes shard 0's head, as the JAX ring does;
those windows start past the series and no caller reads them), and keeps
the first ``per`` bucket ids of each scale: exactly one owner per window
start.  The per-shard int32 ``(S, per)`` stack stays on the shards' devices
for the sharded query steps (parallel/query.py); the index itself is grouped
on the host (index/build.py:build_index_from_buckets), as in the JAX
package.

``Shards`` is a sharded array: its per-shard tensors in mesh order.  It
caches one haloed copy of itself (``haloed``), at the widest halo a query
step has read, as the single-device engines cache their bucket stack.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import IndexConfig
from ..index.build import build_index_from_buckets
from ..index.structure import Index
from ..ops.sliding import build_buckets
from .mesh import Mesh, pad_to_shards


class Shards(list):
    """Per-shard tensors of one array split along its last axis, in mesh
    order, each on its shard's device."""

    def __init__(self, tensors):
        super().__init__(tensors)
        # (halo, pad, fill, per-shard tensors): one haloed copy, the widest
        # asked for so far.
        self._haloed = None
        #: Bytes of the heads copied into halos, summed over every haloed
        #: copy made (what crosses devices on a mesh of several cards).
        self.halo_bytes = 0
        #: Bytes the haloed copy now held allocates on the shards' devices.
        self.haloed_bytes = 0

    @property
    def per(self) -> int:
        """Entries per shard along the sharded axis."""
        return int(self[0].shape[-1])

    def haloed(self, halo: int, pad: int = 0, fill=0) -> List[torch.Tensor]:
        """Each shard with at least the first ``halo`` entries of the next
        shard appended along the last axis (the last shard takes shard 0's),
        then ``pad`` entries of ``fill``; contiguous.

        One haloed copy is kept, at the widest halo asked for so far: a
        reader of ``halo`` entries past its shard stops before a wider
        halo's end, so a narrower request reuses it, and a wider one (or
        other ``pad``/``fill``) replaces it."""
        have = self._haloed
        if have is not None and (pad, fill) == have[1:3] and halo <= have[0]:
            return have[3]
        if have is not None and (pad, fill) == have[1:3]:
            halo = max(halo, have[0])
        if halo > self.per:
            raise ValueError(f"a halo of {halo} needs shards of at least "
                             f"{halo} entries (these hold {self.per})")
        self._haloed, self.haloed_bytes = None, 0  # free the old copy first
        out = []
        for i, x in enumerate(self):
            head = self[(i + 1) % len(self)][..., :halo].to(x.device)
            self.halo_bytes += head.numel() * head.element_size()
            parts = [x, head]
            if pad:
                parts.append(torch.full((*x.shape[:-1], pad), fill,
                                        dtype=x.dtype, device=x.device))
            out.append(torch.cat(parts, dim=-1).contiguous())
            self.haloed_bytes += out[-1].numel() * out[-1].element_size()
        self._haloed = (halo, pad, fill, out)
        return out


def shards_from_numpy(arr: np.ndarray, mesh: Mesh, dtype=None) -> Shards:
    """Split ``arr`` along its last axis into ``mesh.size`` equal pieces,
    each a tensor on its shard's device (the length must divide)."""
    arr = np.asarray(arr)
    n = arr.shape[-1]
    if n % mesh.size:
        raise ValueError(f"length {n} does not divide into {mesh.size} "
                         f"shards (pad with mesh.pad_to_shards)")
    per = n // mesh.size
    return Shards(torch.as_tensor(np.ascontiguousarray(
        arr[..., i * per:(i + 1) * per]), dtype=dtype, device=dev)
        for i, dev in enumerate(mesh.devices))


def shards_to_numpy(shards) -> np.ndarray:
    """The inverse of ``shards_from_numpy``: the pieces joined on the host."""
    return np.concatenate([t.cpu().numpy() for t in shards], axis=-1)


def shard_series(data: np.ndarray, mesh: Mesh) -> Shards:
    """The series zero-padded to the mesh size, float32, split by offset
    range (the JAX package's ``device_put(padded, NamedSharding(mesh,
    P(AXIS)))``)."""
    return shards_from_numpy(
        pad_to_shards(np.asarray(data).astype(np.float32), mesh.size),
        mesh, torch.float32)


def make_sharded_buckets(mesh: Mesh, scales: Tuple[int, ...], pos_of_d: int):
    """The sharded bucket pass: series shards -> int32 ``(S, per)`` bucket
    stack shards; entry ``[s, i]`` of shard k is the bucket of the window
    of scale ``scales[s]`` starting at global position ``k * per + i``."""
    halo = max(scales) - 1

    def run(data: Shards) -> Shards:
        if len(data) != mesh.size:
            raise ValueError(f"{len(data)} series shards for a mesh of "
                             f"{mesh.size}")
        per = data.per
        out = []
        for xh in data.haloed(halo):
            bk = build_buckets(xh, scales, pos_of_d)
            out.append(torch.stack([bk[w][:per] for w in scales]))
        return Shards(out)

    return run


def build_index_sharded(data: np.ndarray, mesh: Mesh, cfg: IndexConfig
                        ) -> Tuple[Index, Shards]:
    """The sharded bucket pass over the mesh, then host grouping.  Returns
    (index, bucket stack shards); the stack stays on the shards' devices
    for the sharded query steps."""
    n = int(np.asarray(data).size)
    scales = tuple(cfg.scales)
    stack = make_sharded_buckets(mesh, scales, cfg.pos_of_d)(
        shard_series(data, mesh))
    host = shards_to_numpy(stack)
    buckets = {w: host[i][: n - w + 1] for i, w in enumerate(scales)}
    return build_index_from_buckets(buckets, n, cfg), stack
