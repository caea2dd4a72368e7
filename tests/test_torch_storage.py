"""Index persistence of the PyTorch port (storage/, utils/codec.py) against
the JAX package's.

The codec's bytes, the ``TimeSeriesFileStore`` files and the
``IndexFileStore`` files of either package are byte-identical; npz round
trips hold for every build of the port (host, device buckets, the full
device build with its pieces kept on the device); the port's engines answer
over a loaded index as over the index it was saved from (query,
query_batch, query_batch_device and the streamed mode), as the JAX engine
does and as the oracle says; a stats-only index raises on save.  All on
the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig as JIndexConfig
from kvmatch_tpu.engine.rsm_ed import QueryEngine as JQueryEngine
from kvmatch_tpu.index.build import build_index_numpy
from kvmatch_tpu.storage import file as jfile
from kvmatch_tpu.utils import codec as jcodec
from kvmatch_tpu_torch import NormQueryEngine, QueryEngine
from kvmatch_tpu_torch.config import IndexConfig, QueryConfig
from kvmatch_tpu_torch.data.generators import generate_series
from kvmatch_tpu_torch.index.build import (build_index_device_buckets,
                                           build_index_host)
from kvmatch_tpu_torch.index.device_build import (build_index_device,
                                                  build_index_device_stats)
from kvmatch_tpu_torch.storage.file import (IndexFileStore, IndexNpzStore,
                                            TimeSeriesFileStore)
from kvmatch_tpu_torch.storage.memory import HbmStore, MemoryStore
from kvmatch_tpu_torch.utils import codec

torch.set_num_threads(2)

N = 30_000
FIELDS = ("keys", "row_ptr", "left", "right", "cum_intervals", "cum_offsets")


@pytest.fixture(scope="module")
def series():
    data = generate_series(N, seed=1)
    return data, build_index_host(data, IndexConfig())


def _same_index(got, want, upper=True):
    assert sorted(got) == sorted(want)
    for w in want:
        assert (got[w].w, got[w].n) == (want[w].w, want[w].n)
        if upper:
            assert got[w].mean_upper_bound == want[w].mean_upper_bound
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got[w], f),
                                          getattr(want[w], f))


def _intervals(rng, k, base=0):
    widths = rng.integers(0, 255, k)
    gaps = rng.integers(1, 600, k)   # gaps past 256 start new groups
    left = base + np.cumsum(gaps) + np.concatenate(([0],
                                                     np.cumsum(widths)[:-1]))
    return left.astype(np.int64), (left + widths).astype(np.int64)


@pytest.mark.parametrize("pos_bytes", [4, 8])
def test_codec_positions_bytes_equal_jax(pos_bytes):
    """encode_positions_compact gives the JAX package's bytes (the int32
    IndexNode codec and the int64 LongIndexNode variant), and both decoders
    invert it; 300 followers in a run exercise the group capacity split."""
    rng = np.random.default_rng(pos_bytes)
    base = 3_000_000_000 if pos_bytes == 8 else 0
    cases = [_intervals(rng, k, base) for k in (1, 17, 400)]
    dense = base + np.arange(300, dtype=np.int64) * 3
    cases.append((dense, dense + 1))
    for left, right in cases:
        blob = codec.encode_positions_compact(left, right, pos_bytes=pos_bytes)
        assert blob == jcodec.encode_positions_compact(left, right,
                                                       pos_bytes=pos_bytes)
        for dec in (codec.decode_positions_compact,
                    jcodec.decode_positions_compact):
            l2, r2 = dec(blob, pos_bytes=pos_bytes)
            np.testing.assert_array_equal(l2, left)
            np.testing.assert_array_equal(r2, right)
    assert codec.encode_positions_compact(np.empty(0), np.empty(0)) == b""


def test_codec_tables_bytes_equal_jax():
    keys = np.array([-3.5, 0.0, 1.05, 8.4])
    ci = np.array([3, 10, 11, 40])
    co = np.array([30, 100, 111, 400])
    blob = codec.encode_statistic_info(keys, ci, co)
    assert blob == jcodec.encode_statistic_info(keys, ci, co)
    for g, w in zip(codec.decode_statistic_info(blob), (keys, ci, co)):
        np.testing.assert_array_equal(g, w)
    assert codec.encode_int_list(co) == jcodec.encode_int_list(co)
    assert codec.encode_long_list(co * 10**10) == \
        jcodec.encode_long_list(co * 10**10)
    np.testing.assert_array_equal(
        codec.decode_long_list(codec.encode_long_list(co * 10**10)),
        co * 10**10)
    np.testing.assert_array_equal(
        codec.decode_int_list(codec.encode_int_list(ci)), ci)


@pytest.mark.parametrize("kind", ["series_raw", "series_npy", "index_file",
                                  "index_file_long"])
def test_files_byte_identical_to_jax(series, tmp_path, kind):
    """Both packages write the same bytes: the reference's big-endian data
    file (and the .npy path), and the reference's per-scale index layout
    (int32 positions, and the int64 Long variant).  Each store reads back
    the other's file equal."""
    data, index = series
    if kind.startswith("series"):
        name = "data.npy" if kind == "series_npy" else "data"
        TimeSeriesFileStore.write(tmp_path / "t" / name, data)
        jfile.TimeSeriesFileStore.write(tmp_path / "j" / name, data)
        files = [(tmp_path / "t" / name, tmp_path / "j" / name)]
        store = TimeSeriesFileStore(tmp_path / "j" / name)
        assert store.length() == N
        np.testing.assert_array_equal(store.read_all(), data)
        np.testing.assert_array_equal(store.read(1234, 777),
                                      data[1234:1234 + 777])
        with pytest.raises(ValueError, match="out of range"):
            store.read(N - 5, 10)
    else:
        pos_bytes = 8 if kind == "index_file_long" else 4
        jindex = build_index_numpy(data, JIndexConfig())
        IndexFileStore(tmp_path / "t", n=N, pos_bytes=pos_bytes).save(index)
        jfile.IndexFileStore(tmp_path / "j", n=N,
                             pos_bytes=pos_bytes).save(jindex)
        files = [(tmp_path / "t" / f"index-{N}-{w}",
                  tmp_path / "j" / f"index-{N}-{w}") for w in index]
        got = IndexFileStore(tmp_path / "j", n=N, pos_bytes=pos_bytes).load()
        _same_index(got, index, upper=False)
        assert got[25].mean_upper_bound == float("inf")
        _same_index(jfile.IndexFileStore(tmp_path / "t", n=N,
                                         pos_bytes=pos_bytes).load(),
                    index, upper=False)
    for mine, theirs in files:
        assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("build", ["host", "device_buckets", "device_keep"])
def test_npz_round_trip(series, tmp_path, build):
    """IndexNpzStore round trips every build of the port, and the JAX
    package's store reads the port's file equal.  A full device build
    keeps its pieces on the device until save takes them to the host."""
    data, host = series
    icfg = IndexConfig()
    if build == "host":
        index = host
    elif build == "device_buckets":
        index = build_index_device_buckets(data, icfg, device="cpu")
    else:
        index = build_index_device(data, icfg, device="cpu")
        assert all(sc._left is None for sc in index.values())
    IndexNpzStore(tmp_path / "i.npz").save(index)
    got = IndexNpzStore(tmp_path / "i.npz").load()
    _same_index(got, index)
    assert all(got[w].left.dtype == np.int64 for w in got)
    _same_index(jfile.IndexNpzStore(tmp_path / "i.npz").load(), index)
    if build != "device_keep":  # the device build's rows differ by design
        _same_index(got, host)


def test_keep_device_index_saves_equal_to_its_host_form(series, tmp_path):
    data, _ = series
    icfg = IndexConfig()
    keep = build_index_device(data, icfg, device="cpu")
    host = build_index_device(data, icfg, keep_device=False, device="cpu")
    assert keep[100].dev_pos_view is not None and keep[100]._left is None
    IndexFileStore(tmp_path / "f", n=N).save(keep)
    _same_index(IndexFileStore(tmp_path / "f", n=N).load(), host,
                upper=False)
    IndexNpzStore(tmp_path / "k.npz").save(keep)
    _same_index(IndexNpzStore(tmp_path / "k.npz").load(), host)


@pytest.mark.parametrize("store", ["npz", "file"])
def test_stats_only_index_raises_on_save(series, tmp_path, store):
    data, _ = series
    index = build_index_device_stats(data, IndexConfig(), device="cpu")
    target = tmp_path / ("s.npz" if store == "npz" else "files")
    st = IndexNpzStore(target) if store == "npz" else \
        IndexFileStore(target, n=N)
    with pytest.raises(ValueError, match="stats-only"):
        st.save(index)
    assert not target.exists()


def test_load_rejects_positions_past_int32(tmp_path):
    n = 2 ** 31
    np.savez(tmp_path / "big.npz", w25_keys=np.zeros(1),
             w25_row_ptr=np.zeros(2, np.int64), w25_left=np.zeros(0, np.int64),
             w25_right=np.zeros(0, np.int64),
             w25_cum_intervals=np.zeros(1, np.int64),
             w25_cum_offsets=np.zeros(1, np.int64),
             w25_meta=np.array([n, 25], np.int64), w25_upper=np.array([1.0]))
    with pytest.raises(ValueError, match="int32"):
        IndexNpzStore(tmp_path / "big.npz").load()
    with pytest.raises(ValueError, match="int32"):
        IndexFileStore(tmp_path, n=n).load()


@pytest.mark.parametrize("route", ["query", "query_batch",
                                   "query_batch_device", "stream"])
def test_queries_from_a_loaded_index(series, tmp_path, route):
    """The port's engines over a loaded index answer as over the saved one,
    as the JAX engine over its own index, and as the oracle."""
    data, index = series
    IndexNpzStore(tmp_path / "i.npz").save(index)
    loaded = IndexNpzStore(tmp_path / "i.npz").load()
    icfg, qcfg = IndexConfig(), QueryConfig(host_verify_max_points=0)
    offs = (2000, 17_000)
    qs = np.stack([data[o:o + 400] for o in offs])
    eps = 5.0

    def answers(index):
        mode = "stream" if route == "stream" else None
        eng = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                          device_data=mode, device="cpu")
        if route in ("query", "stream"):
            res = [eng.query(q, eps) for q in qs]
        else:
            res = getattr(eng, route)(qs, eps)
        return [set(r.offsets.tolist()) for r in res]
    got = answers(loaded)
    assert got == answers(index)
    jeng = JQueryEngine(data, index=build_index_numpy(data, JIndexConfig()))
    for o, q, g in zip(offs, qs, got):
        assert g == set(jeng.query(q, eps).offsets.tolist())
        assert g == set(oracle.rsm_ed(data, q, eps)[0].tolist())
        assert o in g


def test_hbm_store_on_the_cpu(series):
    """HbmStore holds the f32 series on the torch device and the f64 host
    shadow; an engine takes its tensor as device_data."""
    data, index = series
    store = HbmStore(data, device="cpu")
    assert store.device.dtype == torch.float32
    assert store.device.device.type == "cpu" and store.length() == N
    np.testing.assert_array_equal(store.read_all(), data)
    np.testing.assert_array_equal(store.read(10, 5), data[10:15])
    np.testing.assert_array_equal(store.device.numpy(),
                                  data.astype(np.float32))
    q = data[5000:5400]
    kw = dict(alpha=1.5, beta=5.0)
    a = NormQueryEngine(store.host, index=index,
                        device_data=store.device).query(q, 3.0, **kw)
    b = NormQueryEngine(data, index=index, device="cpu").query(q, 3.0, **kw)
    assert set(a.offsets.tolist()) == set(b.offsets.tolist())
    assert 5000 in a.offsets.tolist()
    mem = MemoryStore(data)
    assert mem.length() == N
    np.testing.assert_array_equal(mem.read(3, 4), data[3:7])
    with pytest.raises(ValueError, match="out of range"):
        mem.read(N, 1)
