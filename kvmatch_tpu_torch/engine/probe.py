"""Phase 1 on the card over a resident series: ``ResidentProbe``.

An engine whose series is on the device holds one.  It owns what the
dense probe keeps per series: the copy of the series padded with FLY_FILL
(``padded``), the per-length bucket stack and width-L window statistics
(``bucket_stack``, ``cons_stats``) with the decision whether they fit the
memory budget, and the pass over a same-length query group (``run``).

The pass runs K1 (ops/probe.py:probe_flags) over the whole cached stack in
one launch and, for cNSM, ANDs the guarded alpha/beta window constraint
into the flags with a second kernel (ops/probe.py:cons_and) over the whole
cached statistics, as the JAX package ANDs it in XLA outside its Pallas
kernel.  A table that does not fit is made again for every PROBE_BLOCK of
positions, and each launch covers its block.  Counts stay probe-only, as in
the JAX package.

While a profiler records, the spans ``kv.probe.k1`` and ``kv.probe.cons``
time the two parts' launches on the device, and on the per-block path
``kv.probe.rebuild`` times each block's bucket windows and statistics apart
from them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import backend
from ..config import IndexConfig
from ..ops import probe as probe_ops
from ..ops.probe import (FLAG, FLY_FILL, DenseSegments, cons_and, fly_pad_for,
                         make_bucket_stack, make_cons_stats, probe_flags)
from ..ops.sliding import sliding_window_stats_fwd
from ..utils.profiling import span

__all__ = ["ResidentProbe"]


class ResidentProbe:
    """The dense probe over ``data_dev``, the resident f32 series.

    ``mem_fraction`` (the engine's ``CACHE_MEM_FRACTION``) is the share of
    the device's free memory one cached table may take; it is read when a
    length's table is first asked for, and a table that does not fit is
    not cached, so the next pass asks again."""

    def __init__(self, data_dev: torch.Tensor, icfg: IndexConfig):
        self.data_dev = data_dev
        self.icfg = icfg
        self._padded: Optional[Tuple[int, torch.Tensor]] = None
        self._stacks: dict = {}
        self._stats: dict = {}

    def padded(self, length: int) -> torch.Tensor:
        """The series right-padded with FLY_FILL by ``fly_pad_for``: one
        copy, made again only for a wider padding."""
        pad = fly_pad_for(length, max(self.icfg.scales))
        if self._padded is None or self._padded[0] < pad:
            fill = torch.full((pad,), float(FLY_FILL), dtype=torch.float32,
                              device=self.data_dev.device)
            self._padded = (pad, torch.cat([self.data_dev, fill]))
        return self._padded[1]

    def _fits(self, nbytes: int, mem_fraction: float) -> bool:
        return nbytes <= mem_fraction * \
            backend.device_mem_bytes(self.data_dev.device)

    def bucket_stack(self, length: int,
                     mem_fraction: float) -> Optional[torch.Tensor]:
        """Cached int32 (S, npad) bucket stack of the padded series, or None
        when 4*S bytes a position would not fit the budget."""
        data_p = self.padded(length)
        if length not in self._stacks:
            nbytes = int(data_p.shape[0]) * 4 * len(self.icfg.scales)
            if not self._fits(nbytes, mem_fraction):
                return None
            self._stacks[length] = make_bucket_stack(data_p, self.icfg)
        return self._stacks[length]

    def cons_stats(self, length: int,
                   mem_fraction: float) -> Optional[torch.Tensor]:
        """Cached f32 (3, npad) width-L window statistics for the constraint
        AND, or None when 12 bytes a position would not fit the budget."""
        data_p = self.padded(length)
        if length not in self._stats:
            if not self._fits(int(data_p.shape[0]) * 12, mem_fraction):
                return None
            self._stats[length] = make_cons_stats(data_p, length)
        return self._stats[length]

    def run(self, segs: DenseSegments, eps2: torch.Tensor, cons: torch.Tensor,
            length: int, norm: bool, mem_fraction: float):
        """Phase-1 flags for a same-length query group.

        ``segs`` (pack_segments_batch), ``eps2`` f32 (Q,) and ``cons`` f32
        (Q, 4) rows (alpha, beta, mu_q, sd_q) on the series' device; ``norm``
        for cNSM (the z-space bound and the constraint AND).  Returns
        (counts int32 (Q,) exact probe candidate counts, flags bool (Q, NF),
        rebuilds), flag j covering positions [j*FLAG, (j+1)*FLAG),
        NF = ceil(m/FLAG), on the device; ``rebuilds`` is the number of
        PROBE_BLOCK tables the pass made (0 on the cached path)."""
        icfg = self.icfg
        w_max = max(icfg.scales)
        bstack = self.bucket_stack(length, mem_fraction)
        stats3 = self.cons_stats(length, mem_fraction) if norm else None
        data_p = self.padded(length)
        dev = data_p.device
        Q = eps2.shape[0]
        m = self.data_dev.shape[0] - length + 1
        npos_all = -(-m // FLAG) * FLAG
        flags = torch.zeros((Q, npos_all // FLAG), dtype=torch.bool,
                            device=dev)
        counts = torch.zeros(Q, dtype=torch.int32, device=dev)
        kw = dict(length=length, unit=icfg.unit, d=icfg.d,
                  slack=icfg.probe_guard, norm=norm)
        block = probe_ops.PROBE_BLOCK  # read at call time: callers cut it
        blocks = [(p0, min(block, npos_all - p0))
                  for p0 in range(0, npos_all, block)]
        rebuilds = 0
        with span("kv.probe.k1") as sp:
            if bstack is not None:
                with sp.device(dev):
                    probe_flags(bstack, 0, segs, eps2, cons, 0, npos_all, m,
                                flags, counts, **kw)
            else:
                for p0, npos in blocks:
                    with span("kv.probe.rebuild") as rb, rb.device(dev):
                        bwin = make_bucket_stack(
                            data_p[p0: p0 + npos + length + w_max], icfg)
                    rebuilds += 1
                    with sp.device(dev):
                        probe_flags(bwin, p0, segs, eps2, cons, p0, npos, m,
                                    flags, counts, **kw)
        if norm:
            with span("kv.probe.cons") as sp:
                if stats3 is not None:
                    with sp.device(dev):
                        cons_and(*stats3, cons, 0, npos_all, m, length, flags)
                else:
                    for p0, npos in blocks:
                        with span("kv.probe.rebuild") as rb, rb.device(dev):
                            s1, s2, lo, hi = sliding_window_stats_fwd(
                                data_p[p0: p0 + npos + length - 1], length)
                            amax = torch.maximum(torch.abs(lo), torch.abs(hi))
                        rebuilds += 1
                        with sp.device(dev):
                            cons_and(s1, s2, amax, cons, p0, npos, m, length,
                                     flags)
        return counts, flags, rebuilds
