"""The mixed-segment series of ``generators.py:generate_series`` for large
configurations, drawn in parallel.

The segment law is ``generate_series``'s (DataGenerator.java:81-118):
lengths uniform in [min(1000, 0.01 n), 0.01 n], the kind uniform over random
walk, Gaussian and sine, and the same range for every parameter.  What
differs is how it is drawn:

- the table of segments is drawn from ``seed`` on the host, and segment i is
  filled from child stream i of ``SeedSequence(seed)`` by a pool of host
  threads, so the bits depend only on ``(n, seed)``, not on the number of
  threads;
- the bulk draws are float32, as the series is served: a random walk's step
  is uniform in [-1, 1) (a step uniform in [0, 1) with a random sign has
  that law), summed in float64; a Gaussian segment is drawn by the float32
  ziggurat; a sine's phase and noise are float32.

A configuration picks it with ``"generator": "segments"``; one without the
key keeps ``generate_series``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32 = np.float32


def random_walk(rng: np.random.Generator, length: int) -> np.ndarray:
    start = rng.uniform(-5.0, 5.0)
    steps = rng.random(length - 1, dtype=F32).astype(np.float64)
    steps *= 2.0
    steps -= 1.0
    np.cumsum(steps, out=steps)
    steps += start
    out = np.empty(length, dtype=F32)
    out[0] = start
    out[1:] = steps
    return out


def gaussian(rng: np.random.Generator, length: int) -> np.ndarray:
    mean = rng.uniform(-5.0, 5.0)
    std = rng.uniform(0.0, 2.0)
    out = rng.standard_normal(length, dtype=F32)
    out *= F32(std)
    out += F32(mean)
    return out


def sine(rng: np.random.Generator, length: int,
         noise_frac: float = 0.05) -> np.ndarray:
    freq = rng.uniform(2.0, 10.0)
    amp = rng.uniform(2.0, 10.0)
    mean = rng.uniform(-5.0, 5.0)
    phase = rng.uniform(0.0, 2 * np.pi)
    wave = np.arange(length, dtype=F32)
    wave *= F32(2 * np.pi * freq / length)
    wave += F32(phase)
    np.sin(wave, out=wave)
    wave *= F32(amp)
    out = rng.random(length, dtype=F32)
    out *= F32(2 * amp * noise_frac)
    out += F32(mean - amp * noise_frac)
    out += wave
    return out


GENERATORS = (random_walk, gaussian, sine)


def segment_table(n: int, seed: int, max_segment_frac: float = 0.01):
    """(starts, lengths, kinds) of the segments of a series of ``n``
    points, drawn from ``seed`` by ``generate_series``'s law."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    max_seg = max(1, int(n * max_segment_frac))
    starts, lengths, kinds = [], [], []
    pos = 0
    while pos < n:
        seg_len = min(int(rng.integers(min(1000, max_seg), max_seg + 1)),
                      n - pos)
        starts.append(pos)
        lengths.append(seg_len)
        kinds.append(int(rng.integers(0, len(GENERATORS))))
        pos += seg_len
    return starts, lengths, kinds


def generate(n: int, seed: int, threads: int | None = None) -> np.ndarray:
    """A float32 series of ``n`` points: ``segment_table``'s segments,
    segment i filled from child stream i of ``SeedSequence(seed)``."""
    starts, lengths, kinds = segment_table(n, seed)
    streams = np.random.SeedSequence(seed).spawn(len(starts))
    out = np.empty(n, dtype=F32)

    def fill(i: int) -> None:
        seg = GENERATORS[kinds[i]](np.random.default_rng(streams[i]),
                                   max(lengths[i], 2))
        out[starts[i]:starts[i] + lengths[i]] = seg[:lengths[i]]

    if threads is None:
        threads = len(os.sched_getaffinity(0))
    longest_first = sorted(range(len(starts)), key=lambda i: -lengths[i])
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        for f in [pool.submit(fill, i) for i in longest_first]:
            f.result()
    return out
