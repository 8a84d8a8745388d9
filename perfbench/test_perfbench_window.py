"""The window arithmetic: a rate counts the work that finished inside
the window, requests still in flight included, over the whole window;
a tail is over every request; a stall inside the window moves both."""
import pytest

from perfbench.lib import window

W = (10.0, 20.0)


def _ticks(stall_at=None, stall=0.0):
    t, out = 10.0, []
    while t < 20.0:
        dt = 0.5 + (stall if stall_at is not None and
                    abs(t - stall_at) < 1e-9 else 0.0)
        out.append((t + dt, 100))
        t += dt
    return out


def test_rate_counts_in_flight_work_over_the_whole_window():
    done = [(9.5, 100), (10.5, 50), (19.9, 30), (20.5, 1000)]
    assert window.rate(done, W) == pytest.approx(80 / 10.0)


def test_tail_is_over_every_request():
    reqs = [{"t_submit": 0.0, "times": [10.0 + i / 10]} for i in range(100)]
    reqs.append({"t_submit": 19.0, "times": [19.95]})
    reqs.append({"t_submit": 5.0, "times": [9.0]})           # before
    lat = window.first_token_latencies(reqs, W)
    assert len(lat) == 100                # 99 of the first + the late one
    assert max(lat) == pytest.approx(19.9)
    assert window.percentile(lat, 95) == pytest.approx(
        sorted(lat)[94] + 0.05 * (sorted(lat)[95] - sorted(lat)[94]))


def test_a_stall_inside_the_window_moves_rate_and_tail():
    steady, stalled = _ticks(), _ticks(stall_at=15.0, stall=3.0)
    assert window.rate(stalled, W) < window.rate(steady, W)

    def reqs(ticks):
        return [{"t_submit": a - 0.5, "times": [b]}
                for a, (b, _) in zip([10.0] + [t for t, _ in ticks], ticks)]
    assert window.percentile(
        window.first_token_latencies(reqs(stalled), W), 95) > \
        window.percentile(window.first_token_latencies(reqs(steady), W), 95)


def test_gaps_take_every_later_token_inside():
    reqs = [{"t_submit": 0, "times": [9.0, 10.5, 11.0, 21.0]}]
    assert window.token_gaps(reqs, W) == pytest.approx([1.5, 0.5])
    assert window.percentile([], 95) is None
