"""K2 wrapper: batched window distances for phase 2 of the ED engines.

Port of kvmatch_tpu/ops/ed.py:ed_distances_multi / znorm_ed_distances_multi
on the semantics of the direct gather (ops/ed.py:170-172, 201-211): row b
compares data[offsets[b] : offsets[b] + L] (offsets int64, clamped to
[0, n - L] like jax.lax.dynamic_slice) with queries[qids[b]].  ``window_ed``
launches the CUDA kernel (csrc/window_ed.cu) for CUDA tensors and runs
``window_ed_plain`` for CPU tensors; ``window_ed_plain`` is the plain PyTorch
version on any device.

The JAX package's tiled barrel-shift gather and shift tables are TPU devices
and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend, kernels


def _gather(data: torch.Tensor, offsets: torch.Tensor, length: int):
    """(B, L) windows with dynamic_slice clamping of the start.  A window
    longer than the series (a region row of a short series) repeats the last
    point, as the JAX package's edge-padded device copy does."""
    n = data.shape[0]
    off = torch.clamp(offsets, 0, max(n - length, 0))
    idx = off[:, None] + torch.arange(length, device=data.device)[None, :]
    if length > n:
        idx = idx.clamp_(max=n - 1)
    return data[idx]


def window_ed_plain(data, queries, offsets, qids, length: int, znorm: bool):
    """Plain PyTorch version of K2: d2 (raw) or (d2, mean, std) (z-norm)."""
    x = _gather(data, offsets, length)
    q = queries[qids.long()]
    if not znorm:
        diff = x - q
        return torch.sum(diff * diff, dim=1)
    inv_l = float(np.float32(1.0 / length))
    mean = torch.sum(x, dim=1) * inv_l
    centered = x - mean[:, None]
    var = torch.sum(centered * centered, dim=1) * inv_l
    std = torch.sqrt(var)
    safe = torch.where(std > 0, std, 1.0)
    zdiff = centered / safe[:, None] - q
    d2 = torch.sum(zdiff * zdiff, dim=1)
    d2 = torch.where(std > 0, d2, torch.inf)
    return d2, mean, std


def window_ed(data, queries, offsets, qids, length: int, znorm: bool):
    """Window distances: CUDA kernel K2 for CUDA tensors, the plain version
    for CPU tensors."""
    if backend.route(data) == "plain":
        return window_ed_plain(data, queries, offsets, qids, length, znorm)
    dev = data.device
    B = offsets.shape[0]
    ok = (data.dtype == torch.float32 and data.dim() == 1
          and data.is_contiguous() and queries.device == dev
          and queries.dtype == torch.float32 and queries.dim() == 2
          and queries.shape[1] == length and queries.is_contiguous()
          and offsets.device == dev and offsets.dtype == torch.int64
          and offsets.dim() == 1 and offsets.is_contiguous()
          and qids.device == dev and qids.dtype == torch.int32
          and qids.shape == (B,) and qids.is_contiguous()
          and 0 < length <= data.shape[0] and B > 0)
    if not ok:
        raise ValueError(
            "window_ed: need contiguous f32 data (n,), f32 queries (Q, L), "
            "int64 offsets (B,), int32 qids (B,) on one CUDA device, "
            f"0 < L <= n, B > 0 (got data {tuple(data.shape)} "
            f"{data.dtype}, queries {tuple(queries.shape)}, offsets "
            f"{offsets.dtype}, qids {qids.dtype}, L={length})")
    d2 = torch.empty(B, dtype=torch.float32, device=dev)
    mean = torch.empty(B, dtype=torch.float32, device=dev) if znorm else d2
    std = torch.empty(B, dtype=torch.float32, device=dev) if znorm else d2
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = kernels.lib().kvm_window_ed(
        data.data_ptr(), data.shape[0], queries.data_ptr(), length,
        float(np.float32(1.0 / length)), offsets.data_ptr(), qids.data_ptr(),
        B, int(znorm), d2.data_ptr(), mean.data_ptr(), std.data_ptr(), stream)
    window_ed.launches += 1
    kernels.check(code, "window_ed")
    return (d2, mean, std) if znorm else d2


window_ed.launches = 0


def ed_distances_multi(data, queries, offsets, qids, length: int):
    """Raw squared distances, one query per candidate row."""
    return window_ed(data, queries, offsets, qids, length, znorm=False)


def znorm_ed_distances_multi(data, queries_hat, offsets, qids, length: int):
    """(d2, mean, std) of z-normalized windows against z-normalized queries;
    d2 is inf where std == 0."""
    return window_ed(data, queries_hat, offsets, qids, length, znorm=True)
