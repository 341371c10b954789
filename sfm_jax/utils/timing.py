"""Stage timing / metrics collection.

Equivalent of the reference's timers (Common::PerformanceTimer,
reference SfM/common.h:48-132; TimerGPU/TimerCPU,
CudaSift/cudautils.h:61-107) and its unconditional per-stage printfs.
Here: a structured metrics dict instead of stdout noise; callers end
each timed region with `jax.block_until_ready`.
"""

from __future__ import annotations

import json
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall-clock timer (callers sync)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def record(self, name, seconds):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self):
        return {
            name: {
                "total_ms": round(self.totals[name] * 1e3, 3),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1e3, 3),
            }
            for name in self.totals
        }

    def report(self):
        return json.dumps(self.summary(), indent=2)
