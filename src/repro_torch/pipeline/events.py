"""Structured progress events for long compression runs.

``compress_model_params``'s old progress callback received a bare unit-name
string; pipeline consumers need machine-readable progress (unit, wall-time,
adds before/after, cache activity) to make multi-hour runs observable from
the CLI.  ``str(event)`` renders the human line, so ``progress=print``
works.  Counterpart of ``repro.pipeline.events``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["CompressionEvent", "EventEmitter"]


@dataclass
class CompressionEvent:
    """One pipeline observation.

    kind:
      ``plan``        — job graph built (detail: totals)
      ``unit_start``  — a unit entered the prepare stage
      ``slice_done``  — one slice/channel job finished (possibly from cache)
      ``unit_done``   — a unit fully reduced; adds_before/adds_after filled
      ``cache_hit``   — a job was satisfied from the content-addressed cache
      ``resume``      — a run manifest was restored (detail: what was reused)
      ``budget``      — the allocator chose per-unit plans (detail: totals)
    """

    kind: str
    unit: str = ""
    wall_s: float = 0.0
    adds_before: int | None = None  # CSD shift-add baseline of the unit
    adds_after: int | None = None  # compressed ('lcc' stage) adds
    detail: str = ""
    t: float = field(default_factory=time.time)

    def __str__(self) -> str:
        parts = [self.kind]
        if self.unit:
            parts.append(self.unit)
        if self.kind == "unit_done" and self.adds_before is not None:
            ratio = (self.adds_before / self.adds_after
                     if self.adds_after else float("inf"))
            parts.append(f"adds {self.adds_before}->{self.adds_after} "
                         f"({ratio:.2f}x) in {self.wall_s:.2f}s")
        elif self.wall_s:
            parts.append(f"{self.wall_s:.2f}s")
        if self.detail:
            parts.append(self.detail)
        return "  ".join(parts)


class EventEmitter:
    """Nil-safe fan-out to the user's progress callback.

    With ``metrics=`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`)
    every event also increments ``pipeline_events_total{kind}`` and
    ``slice_done`` walls feed the ``pipeline_job_wall_seconds`` histogram —
    so a multi-hour compression run is observable from the same registry as
    everything else.
    """

    def __init__(self, progress=None, metrics=None):
        self.progress = progress
        self._m_events = self._m_wall = None
        if metrics is not None:
            self._m_events = metrics.counter(
                "pipeline_events_total", "compression events by kind",
                labels=("kind",))
            self._m_wall = metrics.histogram(
                "pipeline_job_wall_seconds", "per-job compression wall")

    def __call__(self, kind: str, **kw) -> None:
        if self._m_events is not None:
            self._m_events.inc(1, kind=kind)
            if kind == "slice_done" and self._m_wall is not None:
                self._m_wall.observe(kw.get("wall_s", 0.0))
        if self.progress is not None:
            self.progress(CompressionEvent(kind=kind, **kw))
