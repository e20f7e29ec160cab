"""Runtime statistics and the port's span recorder (plain Python).

`StatsCollector` is the port's copy of kimera_vio_tpu/utils/stats.py, the
reference's utils::Statistics (src/utils/Statistics.cpp,
utils/Statistics.h:58-206): tag -> windowed accumulator of samples,
printable as the same style of table the reference dumps from
Pipeline::printStatistics (format documented README.md:211-250: `tag
#samples  LogHz  {avg +- std}  [min,max]`).

The span recorder times the calls into each layer where they are made:
`span(name, **ids)` around a call. Recording is off by default, and then `span` returns the shared `NO_SPAN` after
reading one module-level flag: no clock read, no record, no device
work. `start_recording()` turns it on; `stop_recording()` turns it off
and returns what was recorded: every span entered in between, in the
order entered (name, start and end in `time.time_ns()`, the parent span
open on the same thread, the thread's native id, and its ids, inherited
from the parent). `time.time_ns()` is CLOCK_REALTIME, the host clock
`torch.profiler` stamps its events with, so the spans and a profiler
trace line up without conversion. A span's duration (`Span.ms`, and the
`StatsCollector` tags fed from it) is read from the monotonic
`time.perf_counter_ns()`, so a step of the real-time clock cannot bend it.

`SPAN_NAMES` are the names the port records; `StatsCollector.span`
times a call under a span name and feeds its milliseconds to a tag,
whether recording is on or off (the pipeline's and LCD's timings).
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict


class _Accumulator:
    """Windowed accumulator (last `window` samples + lifetime totals).

    Mirrors utils::Accumulator (utils/Statistics.h:58-135): lifetime
    count/min/max/total plus a rolling window for the {avg +- std}
    columns, and sample wall-times for the Log Hz column (the reference
    tracks seconds between AddSample calls, Statistics.cpp GetHz role).
    """

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: list[float] = []
        self.total = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._t_first: float | None = None
        self._t_last: float | None = None

    def add(self, v: float):
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
        self.samples.append(v)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        self.total += v
        self.count += 1
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    @property
    def windowed_mean(self):
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def std(self):
        if len(self.samples) < 2:
            return 0.0
        m = self.windowed_mean
        return math.sqrt(
            sum((s - m) ** 2 for s in self.samples) / (len(self.samples) - 1)
        )

    @property
    def log_hz(self):
        """Samples per second over the accumulator's lifetime — the
        reference table's `Log Hz` column."""
        if self.count < 2 or self._t_last is None:
            return 0.0
        dt = self._t_last - self._t_first
        return (self.count - 1) / dt if dt > 0 else 0.0


class StatsCollector:
    """Global-style stats registry; one per pipeline."""

    def __init__(self):
        self._acc: dict[str, _Accumulator] = defaultdict(_Accumulator)

    def add(self, tag: str, value: float):
        self._acc[tag].add(value)

    def span(self, name: str, tag: str, **ids) -> "Span":
        """A span `name` (recorded while recording is on) that adds its
        milliseconds to `tag` when it ends, recording on or off."""
        return Span(name, ids, self, tag)

    def get(self, tag: str) -> _Accumulator:
        return self._acc[tag]

    def tags(self) -> list[str]:
        return sorted(self._acc)

    def print_table(self) -> str:
        """Reference-style statistics table (README.md:211-250 /
        utils::Statistics::Print, Statistics.h:137-206)."""
        lines = [
            "Statistics",
            f"{'-' * 11:<42}#\tLog Hz\t{{avg     +- std    }}\t[min,max]",
        ]
        for tag in sorted(self._acc):
            a = self._acc[tag]
            lines.append(
                f"{tag:<40}{a.count:>6}\t{a.log_hz:.4g}\t"
                f"{{{a.windowed_mean:.5g} +- {a.std:.5g}}}\t"
                f"[{a.vmin:.4g},{a.vmax:.4g}]"
            )
        return "\n".join(lines)

    def write_timing_csv(self, output_path: str, overall_ms: float):
        """The reference PipelineLogger's `output_timingOverall.csv`
        (src/logging/Logger.cpp:575-582: one header line
        `vio_overall_time [ms]` + the overall duration), the artifact the
        reference CI trends per build (Jenkinsfile:89-95). Extended with
        one column per stat tag (windowed mean) on the same row."""
        import os

        tags = self.tags()
        path = os.path.join(output_path, "output_timingOverall.csv")
        with open(path, "w") as f:
            f.write(
                ",".join(["vio_overall_time [ms]"] + tags) + "\n"
            )
            f.write(
                ",".join(
                    [f"{overall_ms:.3f}"]
                    + [f"{self._acc[t].windowed_mean:.4f}" for t in tags]
                )
                + "\n"
            )
        return path


# ---------------------------------------------------------------------------
# Spans

# Every span the port records (PERF.md, "Spans and counters"): the fleet's
# frame, the frame path, each stream's rest of the frame, the keyframe
# branch, the keyframe half and the backend inside it; the single-stream
# pipeline's and the LCD's timed stages.
SPAN_NAMES = frozenset({
    "fleet.step", "fleet.stream", "fleet.outputs",
    "frontend.track", "frontend.pyramid", "imu.preintegrate", "lk.track",
    "frontend.track_read",
    "frontend.finish", "frontend.keyframe_branch", "frontend.rectify",
    "frontend.ransac_mono", "frontend.detect", "frontend.merge", "frontend.stereo_match",
    "frontend.ransac_stereo", "lk.cache_build",
    "pipeline.keyframe_half", "backend.step", "backend.marginalize", "backend.landmarks",
    "backend.gn_iter", "backend.smart_factors", "backend.imu_factors", "backend.solve",
    "pipeline.bootstrap", "pipeline.vio_step", "pipeline.readback",
    "pipeline.stage_encode", "pipeline.wait_for_stage",
    "lcd.bow_query", "lcd.verify", "lcd.pgo",
})

_recording = False
_lock = threading.Lock()
_spans: list = []
_open = threading.local()  # .stack: the spans open on this thread, innermost last


class _NoSpan:
    """What `span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NO_SPAN = _NoSpan()


class Span:
    """One call into a layer: `name`, `start_ns` / `end_ns` on
    `time.time_ns()`, `ids`, `thread` (native id) and, once recorded,
    `index` (its place in the recording) and `parent` (the index of the
    span open on the same thread when it began, or None). `ms` is its
    duration on `time.perf_counter_ns()`."""

    __slots__ = ("name", "ids", "start_ns", "end_ns", "parent", "thread", "index", "_stats",
                 "_tag", "_t0", "_t1")

    def __init__(self, name: str, ids: dict | None = None, stats: StatsCollector | None = None,
                 tag: str | None = None):
        self.name, self.ids, self._stats, self._tag = name, ids or {}, stats, tag
        self.parent = self.index = self.thread = self.end_ns = None

    def __enter__(self):
        if _recording:
            stack = _stack()
            if stack:
                up = stack[-1]
                self.parent = up.index
                self.ids = {**up.ids, **self.ids} if self.ids else up.ids
            self.thread = threading.get_native_id()
            with _lock:
                self.index = len(_spans)
                _spans.append(self)
            stack.append(self)
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._t1 = time.perf_counter_ns()
        self.end_ns = time.time_ns()
        if self.index is not None:
            stack = _stack()
            if stack and stack[-1] is self:  # not where a new recording began since
                stack.pop()
        if self._stats is not None:
            self._stats.add(self._tag, self.ms)
        return None

    @property
    def ms(self) -> float:
        return (self._t1 - self._t0) * 1e-6


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str, **ids):
    """A context manager timing the call it wraps as span `name` with
    `ids` (the fleet step's number `step`, the stream `b`), or `NO_SPAN`
    while recording is off."""
    if not _recording:
        return NO_SPAN
    return Span(name, ids)


def start_recording():
    """Record every span from here on, in a fresh recording (no
    span open before it is a parent in it)."""
    global _recording, _open
    with _lock:
        _spans.clear()
        _open = threading.local()
    _recording = True


def stop_recording() -> list:
    """Stop recording; returns the spans that ended, in the order they
    began, each `index` its place in this list. A span still open is left
    out, and its children become roots."""
    global _recording
    _recording = False
    with _lock:
        spans = [s for s in _spans if s.end_ns is not None]
        _spans.clear()
    place = {s.index: i for i, s in enumerate(spans)}
    for s in spans:
        s.index, s.parent = place[s.index], place.get(s.parent)
    return spans
