"""Seeded, vectorized synthetic time-series generators.

A copy of kvmatch_tpu/data/generators.py: the same seed gives the same
series in both packages.

NumPy re-design of the reference's generator family (DataGenerator.java:80-118,
data/RandomWalkGenerator.java:25-51, data/GaussianGenerator.java:25-85,
data/SineGenerator.java:25-57): a long series is a concatenation of random-length
segments, each produced by a randomly chosen generator.  Unlike the reference
(java.util.Random, unseeded), everything here flows from one ``numpy.random
.Generator`` so fixtures are reproducible.
"""

from __future__ import annotations

import numpy as np


def random_walk(rng: np.random.Generator, length: int,
                start_range=(-5.0, 5.0), step_range=(0.0, 1.0)) -> np.ndarray:
    start = rng.uniform(*start_range)
    steps = rng.uniform(*step_range, size=length - 1)
    signs = rng.choice(np.array([-1.0, 1.0]), size=length - 1)
    out = np.empty(length)
    out[0] = start
    np.cumsum(steps * signs, out=out[1:])
    out[1:] += start
    return out


def gaussian(rng: np.random.Generator, length: int,
             mean_range=(-5.0, 5.0), std_range=(0.0, 2.0)) -> np.ndarray:
    mean = rng.uniform(*mean_range)
    std = rng.uniform(*std_range)
    return rng.normal(mean, std, size=length)


def sine(rng: np.random.Generator, length: int,
         freq_range=(2.0, 10.0), amp_range=(2.0, 10.0), mean_range=(-5.0, 5.0),
         noise_frac=0.05) -> np.ndarray:
    freq = rng.uniform(*freq_range)
    amp = rng.uniform(*amp_range)
    mean = rng.uniform(*mean_range)
    phase = rng.uniform(0.0, 2 * np.pi)
    i = np.arange(length)
    noise = rng.uniform(-amp * noise_frac, amp * noise_frac, size=length)
    return mean + amp * np.sin(2 * i * (np.pi / length) * freq + phase) + noise


GENERATORS = (random_walk, gaussian, sine)


def generate_series(n: int, seed: int = 0, max_segment_frac: float = 0.01,
                    dtype=np.float64) -> np.ndarray:
    """Mixed-segment synthetic series of length ``n`` (DataGenerator.java:88-118).

    Segment lengths are uniform in [min(1000, max_seg), max_seg] with
    max_seg = n * max_segment_frac, mirroring generateSegment (DataGenerator.java:81-86).
    """
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.float64)
    pos = 0
    max_seg = max(1, int(n * max_segment_frac))
    while pos < n:
        seg_len = int(rng.integers(min(1000, max_seg), max_seg + 1))
        seg_len = min(seg_len, n - pos)
        gen = GENERATORS[int(rng.integers(0, len(GENERATORS)))]
        out[pos:pos + seg_len] = gen(rng, max(seg_len, 2))[:seg_len]
        pos += seg_len
    return out.astype(dtype, copy=False)
