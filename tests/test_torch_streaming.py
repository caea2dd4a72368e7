"""The append build of the PyTorch port (index/streaming.py) against its
from-scratch builds and the JAX package's.

``StreamingIndexBuilder.build()`` equals the port's ``build_index_host`` over
the concatenated series bit for bit (keys, row_ptr, left, right and both cum
arrays), and equals the JAX builder fed the same chunks, whatever the
chunking (the chunkings of tests/test_streaming.py); also after a refresh
and more appends, across a constant run spanning appends, on the bucket
pass's NumPy fallback, and as the index of queries that the oracle checks.
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig as JIndexConfig
from kvmatch_tpu.index.build import build_index_numpy
from kvmatch_tpu.index.streaming import StreamingIndexBuilder as JBuilder
from kvmatch_tpu_torch import NormQueryEngine, QueryEngine, native
from kvmatch_tpu_torch.config import IndexConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.index.build import build_index_host
from kvmatch_tpu_torch.index.streaming import StreamingIndexBuilder

torch.set_num_threads(2)

FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals", "cum_offsets")


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for w in a:
        assert (a[w].n, a[w].w) == (b[w].n, b[w].w)
        assert a[w].mean_upper_bound == b[w].mean_upper_bound
        for f in FIELDS:
            assert np.array_equal(getattr(a[w], f), getattr(b[w], f)), (w, f)


def _feed(builder, data, chunks):
    pos = 0
    for c in chunks:
        builder.append(data[pos:pos + c])
        pos += c
    return builder.build()


@pytest.mark.parametrize("chunks", [
    [30_000],                       # single shot == plain build
    [10_000, 10_000, 10_000],       # equal chunks
    [29_000, 17, 400, 583],         # tiny appends below/around w_max
    [123, 456, 29_421],             # starts below the largest scale
    [0, 399, 1, 29_600],            # an empty append, then w_max - 1 points
])
def test_streaming_equals_host_build_and_jax(chunks):
    data = generate_series(sum(chunks), seed=31)
    got = _feed(StreamingIndexBuilder(IndexConfig()), data, chunks)
    _assert_same(got, build_index_host(data, IndexConfig()))
    _assert_same(got, _feed(JBuilder(JIndexConfig()), data, chunks))
    _assert_same(got, build_index_numpy(data, JIndexConfig()))


def test_streaming_refresh_then_extend():
    """build() mid-stream, keep appending, build() again: both equal the
    host build over their prefix (the caches stay consistent)."""
    icfg = IndexConfig()
    data = generate_series(45_000, seed=32)
    b = StreamingIndexBuilder(icfg)
    b.append(data[:20_000])
    _assert_same(b.build(), build_index_host(data[:20_000], icfg))
    b.append(data[20_000:31_000])
    b.append(data[31_000:])
    _assert_same(b.build(), build_index_host(data, icfg))
    assert b.n == data.size


def test_streaming_constant_run_spanning_appends():
    """A constant region crossing many append boundaries keeps the cap-split
    phase of a from-scratch run-length encoding."""
    icfg = IndexConfig()
    data = generate_series(8_000, seed=33)
    data[2_000:6_500] = 1.0       # constant run >> cap, crosses chunk bounds
    b = StreamingIndexBuilder(icfg)
    for s in range(0, 8_000, 1_000):
        b.append(data[s:s + 1_000])
    _assert_same(b.build(), build_index_host(data, icfg))


def test_streaming_numpy_fallback(monkeypatch):
    """Without the C bucket pass the builder takes the NumPy bucket ids,
    bit-identical."""
    icfg = IndexConfig(maximum_diff=64)
    data = generate_series(12_000, seed=35)
    want = _feed(StreamingIndexBuilder(icfg), data, [5_000, 7_000])
    monkeypatch.setattr(native, "bucket_pass", lambda *a: None)
    _assert_same(_feed(StreamingIndexBuilder(icfg), data, [5_000, 7_000]),
                 want)
    _assert_same(want, build_index_numpy(data, JIndexConfig(maximum_diff=64)))


@pytest.mark.parametrize("engine", ["rsm_ed", "cnsm_ed"])
def test_streaming_queries_exact(engine):
    """The port's engines over a streamed index answer as the oracle."""
    icfg = IndexConfig()
    data = generate_series(40_000, seed=34)
    b = StreamingIndexBuilder(icfg)
    for s in range(0, 40_000, 7_000):
        b.append(data[s:s + 7_000])
    q = data[11_000:11_512]
    if engine == "rsm_ed":
        res = QueryEngine(data, index=b.build(), icfg=icfg,
                          device="cpu").query(q, 5.0)
        want = oracle.rsm_ed(data, q, 5.0)[0]
    else:
        res = NormQueryEngine(data, index=b.build(), icfg=icfg,
                              device="cpu").query(q, 3.0, alpha=1.5, beta=5.0)
        want = oracle.nsm_ed(data, q, 3.0, alpha=1.5, beta=5.0)[0]
    assert set(res.offsets.tolist()) == set(want.tolist())
    assert 11_000 in res.offsets.tolist()
