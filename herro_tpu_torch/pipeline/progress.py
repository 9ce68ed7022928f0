"""Progress reporting.

The reference drives indicatif bars through a notification channel
(src/pbars.rs). Here a small thread-safe reporter prints batch/read progress
to stderr at a throttled rate — structured enough for log scraping, quiet
enough for batch jobs.
"""

from __future__ import annotations

import sys
import threading
import time


class Progress:
    def __init__(self, interval: float = 5.0, stream=None):
        self.interval = interval
        self.stream = stream or sys.stderr
        self._lock = threading.Lock()
        self._total = 0
        self._done = 0
        self._last = 0.0
        self._t0 = time.time()

    def add_batch(self, n: int) -> None:
        with self._lock:
            self._total += n
            self._render(force=True)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._done += n
            self._render()

    def _render(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        rate = self._done / max(now - self._t0, 1e-9)
        print(
            f"[herro-tpu] {self._done}/{self._total} reads corrected "
            f"({rate:.1f} reads/s)",
            file=self.stream,
        )

    def finish(self) -> None:
        with self._lock:
            elapsed = time.time() - self._t0
            print(
                f"[herro-tpu] Processed {self._done} reads in {elapsed:.1f}s.",
                file=self.stream,
            )
