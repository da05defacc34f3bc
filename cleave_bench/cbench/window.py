"""The measured window: whole steps, from the start of the first to the
end of the last.  The step that is running when the time runs out is
finished and counted, so every step the window starts is in it."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class Window:
    steps: int
    seconds: float
    tokens: int
    started: float          # the clock when the first step began

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds


def run_window(step: Callable[[int], None], seconds: float,
               tokens_per_step: int, sync: Callable[[], None],
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Runs ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed
    since the first began; ``sync`` waits for the device at both ends."""
    sync()
    t0 = clock()
    n = 0
    while True:
        step(n)
        n += 1
        if clock() - t0 >= seconds:
            break
    sync()
    elapsed = clock() - t0
    return Window(steps=n, seconds=elapsed, tokens=n * tokens_per_step,
                  started=t0)
