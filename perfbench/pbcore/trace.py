"""The traced window: ``torch.profiler`` over the whole measured window, and
its reduction to what the per-layer readers take — the device's busy
intervals, each kernel's records, the device time under each span and the
host span that each idle gap fell in.

Records are in nanoseconds on the profiler's clock. Spans are the
program's ``gf::`` ranges and the benchmark's own ``pb::`` ranges.
"""

from __future__ import annotations

import bisect
import collections

import torch

#: the profiler drops the device records of a window's first launches (torch
#: 2.11 on an H100): the window opens with this many ``_sleep`` launches,
#: left out of every reading
PAD_LAUNCHES = 16

#: the hand-written kernels and the device kernels each call launches
K1_KERNELS = ("scatter_add_rows_kernel", "scatter_runs_kernel", "scatter_smem_kernel",
              "sum_partials_kernel", "count_rows_kernel", "scan_blocks_kernel",
              "scan_counts_kernel", "place_rows_kernel", "walk_rows_kernel")
K8_KERNELS = ("gather_rows_vec4_kernel", "gather_rows_vec2_kernel", "gather_rows_scalar_kernel")
#: device kernels of one K1 call, by the variant the program picks
K1_KERNELS_PER_CALL = {"atomic": 1, "runs": 1, "vec": 1, "smem": 2, "sorted": 5}


def open_window() -> None:
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


def kernel_of(name: str) -> str | None:
    """``k1``, ``k8`` or ``None`` for a device record's name."""
    if any(k in name for k in K8_KERNELS):
        return "k8"
    if any(k in name for k in K1_KERNELS):
        return "k1"
    return None


class Reduced:
    """The readings of one traced window."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        ops, dev_spans, host_spans = [], collections.defaultdict(list), []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if name.startswith(("gf::", "pb::")):
                    host_spans.append((start, start + dur, name))
                continue
            if name.startswith(("gf::", "pb::")):
                dev_spans[name].append((start, start + dur))
                continue
            if name.startswith("Optimizer.") or "spin_kernel" in name or dur <= 0:
                continue
            ops.append((start, start + dur, name))
        window = [(a, b) for a, b, n in host_spans if n == "pb::window"]
        if len(window) != 1:
            raise RuntimeError(f"the trace holds {len(window)} pb::window spans, not one")
        self.t0, self.t1 = window[0]
        self.ops = sorted(ops)
        self.dev_spans = dict(dev_spans)
        self.host_spans = sorted(s for s in host_spans if s[2] != "pb::window")
        self.busy = merge([(a, b) for a, b, _ in self.ops if b > self.t0 and a < self.t1],
                          self.t0, self.t1)
        self._prefix = [0]
        for a, b in self.busy:
            self._prefix.append(self._prefix[-1] + (b - a))
        self._starts = [a for a, _ in self.busy]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return self._prefix[-1] / 1e9

    def busy_between(self, a: int, b: int) -> int:
        """Nanoseconds in which some device operation ran inside ``[a, b)``."""
        if b <= a or not self.busy:
            return 0
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        total = 0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, e = self.busy[i]
            total += max(0, min(e, b) - max(s, a))
            i += 1
        return total

    def span_device_s(self, name: str) -> float | None:
        """Device busy time under the device ranges of span ``name``
        (overlapping ranges counted once); ``None`` where it never ran."""
        ranges = self.dev_spans.get(name)
        if not ranges:
            return None
        return sum(self.busy_between(a, b) for a, b in merge(ranges, self.t0, self.t1)) / 1e9

    def kernel_records(self, which: str) -> list:
        return [(a, b, n) for a, b, n in self.ops if kernel_of(n) == which
                and a >= self.t0 and b <= self.t1]

    def host_span_s(self, name: str) -> float | None:
        got = [(a, b) for a, b, n in self.host_spans if n == name]
        return None if not got else sum(b - a for a, b in got) / 1e9

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps summed by the innermost host span they fell in."""
        by_op = collections.Counter()
        for a, b, n in self.ops:
            by_op[n[:120]] += (b - a) / 1e9
        gaps = collections.Counter()
        prev = self.t0
        for a, b in self.busy + [(self.t1, self.t1)]:
            if a > prev:
                gaps[self.host_span_at(prev)] += (a - prev) / 1e9
            prev = max(prev, b)
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}

    def host_span_at(self, t: int) -> str:
        """The innermost host span open at ``t`` (the latest to start)."""
        best = None
        i = bisect.bisect_right(self.host_spans, (t, float("inf"), "")) - 1
        # the spans are short and few are open at once: look back a little
        for a, b, n in reversed(self.host_spans[max(0, i - 256):i + 1]):
            if a <= t < b and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "host: between spans"


def merge(intervals, lo: int, hi: int) -> list:
    """Union of ``[a, b)`` intervals clipped to ``[lo, hi)``, sorted."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def profile():
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    return _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
