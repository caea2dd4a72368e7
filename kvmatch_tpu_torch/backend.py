"""Device selection, f32 numerics and kernel routing for the PyTorch port.

Four jobs, all explicit (nothing is picked behind the caller's back):

* ``resolve_device``: turn a device argument into a ``torch.device``; asking
  for ``cuda`` on a machine without a card raises instead of falling back.
* ``configure_numerics``: turn TF32 off for matmul and cuDNN.  The f32 guard
  bands of phase 2 (kvmatch_tpu/verify.py:guard_threshold,
  kvmatch_tpu/ops/regions.py:ERR_C/FFT_ERR_C) assume true f32 arithmetic.
* ``device_mem_bytes``: free device memory from ``torch.cuda.mem_get_info``
  (the JAX package's ``parallel/query.py:_device_mem_bytes`` caps at a 16 GB
  chip; the port reads the card it runs on).
* ``route``: where a kernel wrapper sends a tensor.  A CPU tensor takes the
  plain PyTorch version, a CUDA tensor the hand-written kernel; anything
  else raises.
"""

from __future__ import annotations

import os

import torch


def configure_numerics() -> None:
    """True f32 for matmul and convolutions (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the CPU; ``"cuda"``/``"cuda:k"``/``torch.device`` are
    taken as given and must exist."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                               f"available on this machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on cpu or cuda")
    configure_numerics()
    return dev


def device_mem_bytes(device: torch.device) -> int:
    """Free memory of ``device`` in bytes (host RAM for the CPU)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def route(t: torch.Tensor) -> str:
    """``"plain"`` for a CPU tensor, ``"cuda"`` for a CUDA tensor."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel route for device {t.device}")
