"""The window's arithmetic on synthetic samples."""

import statistics

import pytest

from harness import schedule, stats


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_quartile_distance_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


class FakeClock:
    """A clock that work moves, and each reading by 1 us."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-6
        return self.t


def run_ticks(work_s, rate=60.0):
    """(tick_ms, late_ms) of ticks whose work takes work_s[k] seconds."""
    clock = FakeClock()
    p = schedule.Pacer(rate, clock=clock)
    p.start()
    ticks, late = [], []
    for k, w in enumerate(work_s):
        late.append(p.wait(k) * 1e3)
        clock.t += w  # the tick itself
        ticks.append(schedule.tick_ms(p.due(k), clock()))
    return ticks, late


def test_each_tick_is_timed_from_its_due_time():
    ticks, late = run_ticks([0.002] * 10)
    assert ticks == pytest.approx([2.0] * 10, abs=0.01)
    assert late == pytest.approx([0.0] * 10, abs=0.01)


def test_a_stall_delays_the_ticks_behind_it():
    # A 50 ms stall at tick 2 of a 60 Hz schedule: ticks 3 to 5 start
    # late and count the wait, tick 6 is back on time.
    ticks, late = run_ticks([0.002, 0.002, 0.050, 0.002, 0.002, 0.002,
                             0.002])
    period = 1e3 / 60
    assert ticks[2] == pytest.approx(50.0, abs=0.01)
    assert ticks[3] == pytest.approx(50.0 - period + 2.0, abs=0.01)
    assert ticks[4] == pytest.approx(50.0 - 2 * period + 4.0, abs=0.01)
    assert ticks[5] == pytest.approx(50.0 - 3 * period + 6.0, abs=0.01)
    assert ticks[6] == pytest.approx(2.0, abs=0.01)
    assert late[3] == pytest.approx(50.0 - period, abs=0.01)
    # The tail sees the stall; a percentile over the on-time ticks alone
    # would not.
    assert stats.percentile(ticks, 95) == pytest.approx(50.0, abs=0.01)


def test_rate_is_over_the_whole_window():
    assert schedule.rate(1_000_000, 10.0, 12.0) == pytest.approx(500_000)
