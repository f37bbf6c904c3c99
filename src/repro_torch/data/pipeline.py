"""Prefetching, straggler-tolerant data pipeline (counterpart of
``repro/data/pipeline.py``, the port's own copy).

A background thread produces batches ahead of the training loop (depth-k
prefetch). ``get(timeout)`` mitigates stragglers at the data layer: if a
batch is not ready in time, the miss is counted as a skip and the loop
polls again — batches are stateless functions of their index. A producer
that raises is terminal.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

# Seconds ``stop`` waits for the producer: it checks the stop flag at least
# every 0.05 s unless ``batch_fn`` itself is slow.
_JOIN_S = 5.0


class PrefetchPipeline:
    def __init__(self, batch_fn: Callable[[int], Dict], start_index: int = 0,
                 depth: int = 2):
        self.batch_fn = batch_fn
        self.depth = depth
        self.next_index = start_index
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.skipped = 0
        self._failed_at: Optional[int] = None  # producer death is terminal
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless the pipeline stops first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        idx = self.next_index
        while not self._stop.is_set():
            try:
                batch = self.batch_fn(idx)
            except Exception:  # noqa: BLE001 — reported as the sentinel
                self._put((idx, None))
                return
            if not self._put((idx, batch)):
                return
            idx += 1

    def get(self, timeout: Optional[float] = None):
        """Next (index, batch). On timeout, counts a skip and retries —
        the loop keeps moving past a straggling producer.

        ``timeout`` is passed through verbatim: None blocks, an explicit 0
        polls (a zero-second timeout is a timeout, not "no timeout").
        Producer death is TERMINAL: once the failure sentinel has been
        consumed, every later ``get`` raises at once."""
        while True:
            if self._failed_at is not None:
                raise RuntimeError(
                    f"data producer failed at index {self._failed_at}")
            try:
                idx, batch = self._q.get(timeout=timeout)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError(
                        "data producer is dead and the queue is drained")
                self.skipped += 1
                continue
            if batch is None:
                self._failed_at = idx
                raise RuntimeError(f"data producer failed at index {idx}")
            return idx, batch

    def stop(self) -> None:
        """Stop the producer and wait for it (up to ``_JOIN_S``)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(_JOIN_S)
