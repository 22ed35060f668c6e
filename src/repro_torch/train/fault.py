"""Supervision: straggler detection, heartbeats, bounded retries.

A join session's drainer thread, and the training driver's step loop, record
every batch's or step's duration in a :class:`StragglerMonitor` (one slower than
``factor ×`` the running EMA is a straggler event) and touch a :class:`Heartbeat`
file, so an external watchdog can tell a wedged process from a busy one;
:func:`retry` bounds retries of transient host-side failures (checkpoint I/O).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional


@dataclass
class StragglerMonitor:
    factor: float = 2.5          # slow-step threshold vs EMA
    alpha: float = 0.1           # EMA weight
    warmup: int = 3              # ignore the first steps (compile, cache warm)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _ema: Optional[float] = field(default=None, init=False)
    _n: int = field(default=0, init=False)
    events: List[dict] = field(default_factory=list, init=False)

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is flagged as a straggler event."""
        self._n += 1
        if self._n <= self.warmup:
            return False
        if self._ema is None:
            self._ema = duration_s
            return False
        slow = duration_s > self.factor * self._ema
        if slow:
            self.events.append({"step": step, "duration_s": duration_s, "ema_s": self._ema})
            if self.on_straggler:
                self.on_straggler(step, duration_s, self._ema)
        # clamp the update so one straggler doesn't poison the EMA
        upd = min(duration_s, self.factor * self._ema)
        self._ema = (1 - self.alpha) * self._ema + self.alpha * upd
        return slow

    def reset(self) -> None:
        """Forget the latency model (EMA + warmup), keep the event log.

        Supervised-restart hook: after a crash/recovery cycle the first
        post-restart steps recompile and re-warm caches, so judging them
        against the pre-crash EMA would flag every one of them."""
        self._ema = None
        self._n = 0

    @property
    def ema_s(self) -> Optional[float]:
        return self._ema


class Heartbeat:
    """Touch a file every step; an external watchdog restarts the process when the
    mtime goes stale (the launcher's auto-resume makes the restart cheap)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int) -> None:
        self.path.write_text(f"{step} {time.time()}\n")

    def age_s(self) -> Optional[float]:
        if not self.path.exists():
            return None
        return time.time() - self.path.stat().st_mtime


def retry(fn: Callable, attempts: int = 3, backoff_s: float = 1.0,
          retriable=(OSError, IOError)):
    """Bounded retry for transient host-side failures (checkpoint I/O, RPC):
    ``fn()`` up to ``attempts`` times, sleeping ``backoff_s · 2^i`` after the
    i-th failure; re-raises the last one."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            last = e
            time.sleep(backoff_s * (2 ** i))
    raise last
