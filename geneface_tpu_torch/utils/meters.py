"""Metric meters (port of ``geneface_tpu/utils/meters.py``)."""

from __future__ import annotations

from collections import defaultdict

__all__ = ["AvgMeter", "MeterBank"]


class AvgMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MeterBank:
    """Named collection of :class:`AvgMeter`; ``update({"loss": 0.1})``.
    Values may be 0-d tensors (reading them waits for the device)."""

    def __init__(self):
        self.meters: dict[str, AvgMeter] = defaultdict(AvgMeter)

    def update(self, values: dict, n: int = 1) -> None:
        for k, v in values.items():
            try:
                self.meters[k].update(float(v), n)
            except (TypeError, ValueError, RuntimeError):
                pass

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self) -> None:
        self.meters.clear()
