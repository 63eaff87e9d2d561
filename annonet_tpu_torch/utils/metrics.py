"""Structured training metrics: a JSON-lines event stream (the port's copy
of ``annonet_tpu/utils/metrics.py``: the same events and fields).

The reference's only training observability is stdout (verbose loss/LR
lines via BeVerbose, annonet_train_main.cpp:404; config echo :322-374).
This module adds the production counterpart: `annonet_train
--metrics-jsonl PATH` appends one JSON object per event, machine-readable
by dashboards/log shippers, without changing any printed output.

Events (all carry ``time`` = unix seconds):

- ``start``: once, with the resolved run configuration.
- ``loss``: every Nth RECORDED training loss (N = --metrics-interval),
  with ``step``, ``loss``, ``learning_rate``, ``steps_without_progress``
  and ``steps_per_second`` — the CUMULATIVE recorded-step rate since the
  first recorded loss. Cumulative deliberately: under
  --loss-sync-interval/--steps-per-dispatch batching losses are recorded
  in bursts at flush time, so a between-events rate would measure the
  flush, not the training; the cumulative rate converges on the
  sustained steps/s.
- ``learning_rate_shrink``: every plateau-driven LR decay (never
  downsampled).
- ``save``: every model-artifact write, with ``step`` and ``path``.
- ``done``: once at exit, with ``steps`` and ``wall_seconds``.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class MetricsWriter:
    """Append-mode JSONL event writer; line-buffered (flush per event).

    Wire ``writer.hook`` to ``Trainer.metrics_hook``; call ``event`` for
    CLI-level records (start/save/done) and ``close`` at exit. Not
    thread-safe — the training loop is single-threaded at this layer.
    """

    def __init__(self, path: str, interval: int = 1):
        self.path = path
        self.interval = max(1, int(interval))
        self._fh: Optional[IO[str]] = open(path, "a", encoding="utf-8")
        self._kept_losses = 0
        self._first_loss_step: Optional[int] = None
        self._first_loss_time: Optional[float] = None

    # ------------------------------------------------------------- emit

    def event(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        record = {"event": event, "time": time.time()}
        record.update(fields)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def hook(self, record: dict) -> None:
        """Trainer.metrics_hook target: downsample loss events to every
        ``interval``th, annotating each kept one with the cumulative
        recorded-step rate; pass everything else (LR shrinks) through
        verbatim."""
        if record.get("event") != "loss":
            self.event(**record)
            return
        self._kept_losses += 1
        if self._first_loss_time is None:
            self._first_loss_step = record["step"]
            self._first_loss_time = time.monotonic()
        if self._kept_losses % self.interval:
            return
        now = time.monotonic()
        step = record["step"]
        if step > self._first_loss_step and now > self._first_loss_time:
            rate = (step - self._first_loss_step) / (
                now - self._first_loss_time
            )
            record = dict(record, steps_per_second=round(rate, 3))
        self.event(**record)

    # ------------------------------------------------------------ close

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
