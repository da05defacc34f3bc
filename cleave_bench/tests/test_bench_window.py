"""The window's arithmetic: whole steps over the time from the first
step's start to the last step's end."""
from cbench.window import run_window


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run(step_times, seconds, tokens=100):
    clock = FakeClock()

    def step(i):
        clock.t += step_times[i]

    return run_window(step, seconds, tokens, lambda: None, clock)


def test_step_running_at_the_deadline_counts():
    w = _run([1.0] * 10, 2.5)
    assert w.steps == 3 and w.seconds == 3.0
    assert w.tokens_per_s == 300 / 3.0


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = _run([1.0] * 10, 4.0)
    stalled = _run([1.0, 3.0, 1.0, 1.0, 1.0], 4.0)
    assert steady.tokens_per_s == 100.0
    assert stalled.steps == 2 and stalled.seconds == 4.0
    assert stalled.tokens_per_s == 50.0 < steady.tokens_per_s


def test_window_starts_at_the_first_step():
    w = _run([2.0] * 5, 1.0)
    assert w.started == 0.0 and w.steps == 1 and w.seconds == 2.0
