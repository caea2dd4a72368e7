"""Device meshes for offset-range sharding (port of
kvmatch_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D ``jax.sharding.Mesh`` under
``shard_map``: the series is split by offset range, halos replace the
reference's cross-region re-reads, and collectives replace its shuffle.
The port keeps that single-controller shape without a process group: a
``Mesh`` is an ordered tuple of ``torch.device``, one shard each, and one
process drives every shard.  Each shard's tensors live on its own device;
a halo is a ``.to(next_device)`` copy of the neighbour's head, and the
JAX collectives (``psum``, the candidate all-gather) are concatenations on
the mesh's first device.  A device may repeat, so one card holds several
shards (``Mesh(["cuda:0"] * 4)``) and the CPU tests hold eight
(``Mesh(["cpu"] * 8)``); a box with four cards takes ``cuda:0..3``.

``shard_spec`` and ``replicated`` (``PartitionSpec``s of the JAX module)
have no counterpart: a sharded array is a list of per-shard tensors in mesh
order (parallel/build.py:Shards), a replicated one any tensor or array,
copied to each shard's device by the step that reads it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An ordered tuple of ``torch.device``, one per shard (devices may
    repeat)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "make_mesh() with no devices takes every visible CUDA device, "
            "and torch.cuda has none on this machine (pass a device list, "
            "e.g. ['cpu'] * 8, to shard on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` in the given order; every visible CUDA
    device when None (raises without one)."""
    return Mesh(devices if devices is not None else _visible_cuda_devices())


def pad_to_shards(x: np.ndarray, n_shards: int, pad_value=0.0) -> np.ndarray:
    """Right-pad so the length divides the mesh size."""
    pad = (-x.size) % n_shards
    if pad:
        x = np.concatenate([x, np.full(pad, pad_value, x.dtype)])
    return x


def _device_id(d: torch.device, position: int) -> int:
    """The id a device is ordered by: its CUDA index, else (a CPU device)
    its position in the list it came in."""
    return d.index if d.index is not None else position


def order_devices_for_ring(devices: Optional[Sequence] = None,
                           slice_of=None) -> list:
    """Order devices so the offset-range ring crosses slow links least.

    Every sharded step exchanges data only with the NEXT device in mesh
    order (a ring), so on a multi-host or multi-slice layout the ring
    crosses the slow link once per boundary if and only if devices are
    ordered slice-major.  ``slice_of`` maps a device's id (its CUDA index;
    a CPU device's position in the list) to its slice, as a mapping or a
    callable; without it every device is in slice 0 and the order is by id
    (the JAX version's ``d.id``), which keeps a single-host or CPU list as
    it is.  Ties keep the input order.
    """
    devices = [torch.device(d) for d in (
        devices if devices is not None else _visible_cuda_devices())]
    ids = [_device_id(d, i) for i, d in enumerate(devices)]
    if slice_of is None:
        key = lambda i: (0, ids[i])  # noqa: E731
    elif callable(slice_of):
        key = lambda i: (slice_of(ids[i]), ids[i])  # noqa: E731
    else:
        key = lambda i: (slice_of[ids[i]], ids[i])  # noqa: E731
    return [devices[i] for i in sorted(range(len(devices)), key=key)]


def make_mesh_multislice(devices: Optional[Sequence] = None,
                         slice_of=None) -> Mesh:
    """1-D offset mesh in slice-major device order (order_devices_for_ring)."""
    return make_mesh(order_devices_for_ring(devices, slice_of=slice_of))
