"""The end-to-end statistics (a percentile of every call, a rate over the
whole window) and the bounds' arithmetic."""
import random
import time

import numpy as np
import pytest
import torch

from benchmarks import harness, roofline, scenes


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 1000])
def test_percentile_is_numpys_linear_percentile(n):
    xs = [random.Random(n).random() for _ in range(n)]
    for q in (50, 95, 99):
        assert harness.percentile(xs, q) == pytest.approx(np.percentile(xs, q), abs=1e-12)


def _slow_every(k: int, slow_s: float, fast_s: float):
    i = [0]

    def call(x):
        time.sleep(slow_s if i[0] % k == k - 1 else fast_s)
        i[0] += 1
        return x

    return call


def _loop(call, in_flight=4):
    t = scenes.Traffic.from_dict(dict(scenes=1, times=2, batch=1, batched=False, in_flight=in_flight,
                                      check_calls=1))
    inputs = scenes.make_inputs(t, 32, 32, 1, "cpu")
    return harness.Loop(call, inputs, in_flight, torch.device("cpu"),
                        scenes.reservoir(random.Random(0), 1))


def test_the_tail_is_over_every_call():
    """One call in ten is slow: the 95th percentile of all calls is a slow
    call, where a median of chunks of calls would read a fast one."""
    loop = _loop(_slow_every(10, 0.004, 0.0))
    loop.run(float("inf"), max_calls=200)
    loop.drain()
    assert len(loop.times_ms) == 200
    assert harness.percentile(loop.times_ms, 95) >= 3.5
    chunks = [sorted(loop.times_ms[i:i + 20])[10] for i in range(0, 200, 20)]
    assert max(chunks) < 1.0


def test_every_call_is_retired_and_in_flight_is_kept():
    seen = []

    def call(x):
        seen.append(len(loop.pending))
        return x

    loop = _loop(call, in_flight=3)
    loop.run(float("inf"), max_calls=50)
    assert max(seen) == 2  # a call is issued once fewer than 3 are outstanding
    loop.drain()
    assert len(loop.times_ms) == 50 and not loop.pending and len(loop.host_us) == 50


def test_the_rate_is_every_frame_over_the_whole_window():
    suite = harness.Suite.load()
    from benchmarks.tests.helpers import small_run

    r = small_run(suite, "cam1080p.x8_calm", seconds=0.4)
    run = r["run"]
    assert r["attempted"] == run["calls"] * 8
    assert r["metrics"]["frames_per_s"]["value"] == pytest.approx(r["attempted"] / run["window_s"])
    assert run["window_s"] >= 0.4
    assert r["metrics"]["call_p95_ms"]["value"] >= run["call_p50_ms"]


def test_bounds_follow_their_formulas():
    assert roofline.chain_ops(5) == 96 and roofline.chain_ops(3) == 64
    nbytes, ops = roofline.ff_pack_work(1080, 1920, 3, 5)
    assert nbytes == 1080 * 1920 * 3 + 2 * 4 * 34 * 1920 and ops == 96 * 1080 * 1920
    s, what = roofline.bound_s(nbytes, ops)
    assert what == "operations" and s == pytest.approx(ops / 67e12)
    nbytes, ops = roofline.unpack_work(4320, 7680)
    assert nbytes == 4 * 135 * 7680 + 4320 * 7680 and ops == 0
    s, what = roofline.bound_s(nbytes, ops)
    assert what == "bytes" and s == pytest.approx(nbytes / 3.35e12)
    nbytes, ops = roofline.pipeline_work(1080, 1920, 3, 5)
    assert nbytes == 4 * 1080 * 1920 and ops == 96 * 1080 * 1920


def test_reservoir_keeps_a_uniform_sample():
    hits = [0] * 20
    for seed in range(2000):
        keep, kept = scenes.reservoir(random.Random(seed), 4), {}
        for i in range(20):
            slot = keep(i)
            if slot is not None:
                kept[slot] = i
        for i in kept.values():
            hits[i] += 1
    assert all(abs(h / 2000 - 4 / 20) < 0.05 for h in hits)
