"""The open loop's latency runs from each request's due time, a request
never served counts, and the percentile is over every request."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, readers, traffic


def ctx(reqs, drain_end):
    return SimpleNamespace(requests=reqs, drain_end=drain_end)


def test_latency_runs_from_the_due_time():
    # all four due at once: the client serves them one after another, so
    # the last waits for the three before it
    calls = []

    def call(x):
        calls.append(x)
        time.sleep(0.05)
        return {}

    reqs = harness.open_loop(call, [0, 1], [(0.0, 0), (0.0, 1), (0.0, 0), (0.0, 1)], 10.0)
    lat = [r.end - r.due for r in reqs]
    assert all(r.done for r in reqs) and calls == [0, 1, 0, 1]
    assert lat[-1] >= 0.2 - 1e-3 and lat == sorted(lat)
    assert readers.latency_percentile_ms(ctx(reqs, 10.0), {"q": 95}) == pytest.approx(1e3 * lat[-1])


def test_requests_not_started_before_the_drain_ends_fail():
    def call(x):
        time.sleep(0.2)
        return {}

    reqs = harness.open_loop(call, [0], [(0.0, 0), (0.01, 0), (0.02, 0)], 0.1)
    assert [r.done for r in reqs] == [True, False, False]
    # an unserved request is slower than any served one: at least its due
    # time to the drain's end
    p = readers.latency_percentile_ms(ctx(reqs, 5.0), {"q": 95})
    assert p == pytest.approx(1e3 * (5.0 - 0.01))


def test_p95_is_over_all_requests_not_medians_of_chunks():
    # 100 requests: 90 fast, then 10 slow in one burst; chunked medians of
    # ten would put the tail at one chunk's median
    reqs = []
    for i in range(100):
        r = harness.Request(due=float(i), idx=0, start=float(i))
        r.end = r.due + (1.0 if i >= 90 else 0.01)
        reqs.append(r)
    p95 = readers.latency_percentile_ms(ctx(reqs, 200.0), {"q": 95})
    assert p95 == pytest.approx(1000.0)
    chunk_medians = sorted(sorted(r.end - r.due for r in reqs[j : j + 10])[5] for j in range(0, 100, 10))
    assert chunk_medians[-1] * 1e3 == pytest.approx(1000.0) and chunk_medians[8] * 1e3 == pytest.approx(10.0)
    # nearest rank: the 95th of 100 is the 95th smallest
    reqs[94].end = reqs[94].due + 0.5
    assert readers.latency_percentile_ms(ctx(reqs, 200.0), {"q": 95}) == pytest.approx(1000.0)


def test_open_schedule_keeps_its_set_of_gaps_across_seeds():
    mix = {"rate_per_s": 25.0, "pool": 32, "block_s": 1.0, "pattern_seed": 3}
    a = traffic.open_schedule(mix, 1, 30.0)
    b = traffic.open_schedule(mix, 2**31 + 5, 30.0)
    assert len(a) == len(b) == 750
    # the same gaps in another order: those between due times and the last
    # one to the window's end; every second holds the same number of requests
    gaps = lambda s: sorted([y[0] - x[0] for x, y in zip(s, s[1:])] + [30.0 - s[-1][0]])
    assert a != b and gaps(a) == pytest.approx(gaps(b), abs=1e-9)
    for s in (a, b):
        assert [sum(1 for t, _ in s if k - 1e-9 <= t < k + 1 - 1e-9) for k in range(30)] == [25] * 30
    assert sorted(i for _, i in a) == sorted(i for _, i in b)
    assert all(0.0 <= t < 30.0 for t, _ in a)
    # the same set of blocks, each second's arrivals the same in both, in
    # another order of seconds
    blocks = lambda s: sorted(tuple(round(t - k, 9) for t, _ in s if k - 1e-9 <= t < k + 1 - 1e-9)
                              for k in range(30))
    assert blocks(a) == blocks(b)
    assert [t for t, _ in a] != [t for t, _ in b]
    # another pattern seed draws other blocks
    assert blocks(traffic.open_schedule(dict(mix, pattern_seed=4), 1, 30.0)) != blocks(a)


def test_generator_lateness_counts_only_idle_starts():
    r1 = harness.Request(due=0.0, idx=0, start=0.001, end=0.5)
    r2 = harness.Request(due=0.1, idx=0, start=0.5, end=0.9)  # queued: not the generator's lateness
    r3 = harness.Request(due=1.0, idx=0, start=1.002, end=1.2)
    assert harness.generator_late_ms([r1, r2, r3]) == pytest.approx(2.0)
