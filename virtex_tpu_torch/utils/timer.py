r"""
Step timer with a moving-window average and an ETA, and images per second.

Counterpart of ``virtex_tpu/utils/timer.py``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional


class Timer:
    def __init__(self, start_from: int = 1,
                 total_iterations: Optional[int] = None, window: int = 20):
        self.current_iter = start_from - 1
        self.total = total_iterations
        self._deque = deque(maxlen=window)
        self._start = time.perf_counter()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        """Ends the step; returns its seconds."""
        seconds = time.perf_counter() - self._start
        self._deque.append(seconds)
        self.current_iter += 1
        return seconds

    @property
    def avg(self) -> float:
        return sum(self._deque) / max(len(self._deque), 1)

    def throughput(self, batch_size: int) -> float:
        """Items per second over the window."""
        return batch_size / self.avg if self._deque else 0.0

    @property
    def eta_hhmm(self) -> str:
        if not self.total or not self._deque:
            return "--:--"
        remaining = self.avg * (self.total - self.current_iter)
        return f"{int(remaining // 3600):02d}:{int(remaining % 3600 // 60):02d}"

    @property
    def stats(self) -> str:
        msg = f"Iter {self.current_iter} | Time: {self.avg:.3f} sec"
        if self.total:
            msg += f" | ETA: {self.eta_hhmm}"
        return msg
