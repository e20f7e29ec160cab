"""Runtime statistics collection; the port's copy of
kimera_vio_tpu/utils/stats.py (plain Python). The reference's
utils::Statistics (src/utils/Statistics.cpp, utils/Statistics.h:58-206): tag -> windowed
accumulator of samples, printable as the same style of table the reference
dumps from Pipeline::printStatistics (format documented README.md:211-250:
`tag  #samples  LogHz  {avg +- std}  [min,max]`)."""

from __future__ import annotations

import math
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

    def summary(self) -> dict:
        """Per-tag windowed means (for bench JSON per-stage fields)."""
        return {
            tag: round(a.windowed_mean, 4) for tag, a in self._acc.items()
        }

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
