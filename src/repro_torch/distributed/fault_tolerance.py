"""Fault-tolerance runtime of one host: heartbeat watchdog and straggler
monitor (counterpart of ``repro/distributed/fault_tolerance.py``).

On a multi-host deployment these hooks attach to the coordination service
(missing heartbeat -> evict host -> restore on the survivors); here they
run single-host and the trainer wires them together. The reference's
``elastic_restore`` (a checkpoint restored onto another mesh) waits for
the port's DP×TP mesh.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class Watchdog:
    """Fires `on_timeout` if `beat()` isn't called within `timeout_s`.

    One-shot per beat: firing disarms the watchdog until the next
    ``beat()``, and the elapsed-check + disarm happen under the lock
    ``beat()`` takes — so a heartbeat racing the timeout check either lands
    before it (no fire) or after it (re-arms for the NEXT interval); the
    watchdog never fires twice for one stall nor for a stall a beat already
    ended. The callback runs outside the lock.
    """

    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._armed = True
        self._stop = threading.Event()
        self.fired = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._armed = True

    def _run(self) -> None:
        while not self._stop.wait(self.timeout_s / 4):
            fire = False
            with self._lock:
                if (self._armed
                        and time.monotonic() - self._last > self.timeout_s):
                    self.fired += 1
                    self._armed = False  # one shot until the next beat
                    self._last = time.monotonic()
                    fire = True
            if fire:
                self.on_timeout()

    def stop(self) -> None:
        """Stop the checker thread and wait for it (not from the callback,
        which runs on that thread)."""
        self._stop.set()
        if threading.current_thread() is not self._thread:
            self._thread.join()


class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than `ratio`× the EMA."""

    def __init__(self, ratio: float = 2.0, decay: float = 0.9):
        self.ratio = ratio
        self.decay = decay
        self.ema: Optional[float] = None
        self.flagged: List[int] = []

    def reset(self) -> None:
        """Forget the EMA and the flag history — a restarted run's first
        steps (kernel builds, warm caches) must not be judged against the
        pre-restart steady state."""
        self.ema = None
        self.flagged = []

    def record(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.ratio * self.ema
        if is_straggler:
            self.flagged.append(step)
        else:  # outliers stay out of the EMA so one does not mask the next
            self.ema = dt if self.ema is None else (
                self.decay * self.ema + (1 - self.decay) * dt)
        return is_straggler
