"""A rate is all the window's work over all its time, and the tail is
taken over every call: a window with one stall shows it in both."""

import time

import numpy as np
import pytest

from benchmark import run


class _Fake:
    unit_metric = "retrieve_users_per_s"
    latency_metric = "retrieve_p95_ms"

    def __init__(self, durations, units=64):
        self.durations = list(durations)
        self.units = units
        self.i = 0

    def call(self):
        time.sleep(self.durations[self.i % len(self.durations)])
        self.i += 1
        return self.units

    def sync(self):
        pass


def test_the_rate_and_tail_of_a_hand_made_window_with_a_stall():
    # 90 calls of 1 ms and 10 of 50 ms (a stall of the card, say)
    lat = [0.001] * 90 + [0.05] * 10
    elapsed = sum(lat)
    out = run.summarize(_Fake([]), 64 * len(lat), lat, elapsed)
    assert out["retrieve_users_per_s"] == pytest.approx(6400 / 0.59)
    # the median of windows of 20 calls would read 64 / 1 ms
    assert out["retrieve_users_per_s"] < 0.2 * 64 / 0.001
    assert out["retrieve_p95_ms"] == pytest.approx(50.0)


def test_the_window_counts_a_stall_in_its_time():
    fake = _Fake([0.002] * 9 + [0.08])
    work, lat, elapsed = run.window(fake, 0.3)
    assert len(lat) == fake.i and work == 64 * fake.i
    assert elapsed >= sum(lat) >= 0.3
    assert max(lat) >= 0.08
    rate = run.summarize(fake, work, lat, elapsed)["retrieve_users_per_s"]
    assert rate == pytest.approx(work / elapsed)
    assert rate < 64 / float(np.median(lat))


def test_a_training_driver_reports_no_tail():
    class _Train(_Fake):
        unit_metric = "train_examples_per_s"
        latency_metric = None

    out = run.summarize(_Train([]), 1000, [0.5, 0.5], 1.0)
    assert out == {"train_examples_per_s": 1000.0}
