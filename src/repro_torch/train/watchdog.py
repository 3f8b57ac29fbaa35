"""Straggler / hang watchdog around a step function.

A copy of ``repro.train.watchdog``: a step longer than
``straggler_factor`` × the step-time EMA (after ``min_samples`` steps), or
longer than ``hang_timeout_s``, is recorded in ``events`` and passed to
the policy callback. The streaming detector wraps each device step in it
(``stream.telemetry.StreamTelemetry``). Clock-injectable for
deterministic tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class WatchdogConfig:
    ema_alpha: float = 0.1
    straggler_factor: float = 2.0     # flag if step > factor × EMA
    hang_timeout_s: float = 300.0     # flag if step exceeds hard timeout
    min_samples: int = 5


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig | None = None,
                 on_straggler: Callable[[dict], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or WatchdogConfig()
        self.on_straggler = on_straggler or (lambda info: None)
        self.clock = clock
        self.ema: float | None = None
        self.n = 0
        self.events: list[dict] = []
        self._t0: float | None = None

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self) -> float:
        assert self._t0 is not None, "step_start not called"
        dt = self.clock() - self._t0
        self._t0 = None
        self.n += 1
        flagged = False
        if dt > self.cfg.hang_timeout_s:
            flagged = True
            reason = "hang"
        elif (self.ema is not None and self.n > self.cfg.min_samples
                and dt > self.cfg.straggler_factor * self.ema):
            flagged = True
            reason = "straggler"
        if flagged:
            info = {"step_time_s": dt, "ema_s": self.ema, "reason": reason,
                    "step": self.n}
            self.events.append(info)
            self.on_straggler(info)
        a = self.cfg.ema_alpha
        self.ema = dt if self.ema is None else (1 - a) * self.ema + a * dt
        return dt
