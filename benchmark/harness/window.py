"""The closed loop and its host-clock statistics."""

import math
import time

import numpy as np


def p95(values):
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


class Reservoir:
    """A seeded sample of ``k`` items per key (reservoir sampling): which
    calls of each pool batch the comparison reads."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.seen = {}
        self.kept = {}

    def offer(self, key, item):
        n = self.seen[key] = self.seen.get(key, 0) + 1
        kept = self.kept.setdefault(key, [])
        if len(kept) < self.k:
            kept.append(item)
        else:
            j = int(self.rng.integers(0, n))
            if j < self.k:
                kept[j] = item


def closed_loop(call, pool, seconds, sample, min_calls=0):
    """One caller: ``call(batch)`` (which returns once its results are on
    the host) on the pool's batches in turn, the next call when the last
    returns, from the first call's start until ``seconds`` have passed
    (and at least ``min_calls`` calls).  ``sample.offer(pool index,
    results)`` sees every call.  Returns (latencies s,
    window s, calls per pool batch)."""
    lat = []
    counts = [0] * len(pool)
    start = time.perf_counter()
    now = start
    i = 0
    while now - start < seconds or i < min_calls:
        p = i % len(pool)
        t0 = time.perf_counter()
        out = call(pool[p])
        now = time.perf_counter()
        lat.append(now - t0)
        counts[p] += 1
        sample.offer(p, out)
        i += 1
    return lat, now - start, counts
