"""Arithmetic shared by the per-layer readers in ``metrics/``: each reader
takes the run's context (the cell, the window's output, the reduced trace,
the recorded K1/K8 calls) and returns a number, or ``None`` where the window
holds nothing to read."""

from __future__ import annotations

from counts import bytes as by
from counts import flops as fl
from pbcore import trace as tr


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every request's latency, in ms (numpy's
    linear interpolation between order statistics)."""
    import numpy as np

    return float(np.percentile(np.asarray(latencies_s, dtype=np.float64), 95)) * 1e3


def idle_share(ctx) -> float:
    t = ctx["trace"]
    return 1.0 - t.busy_s / t.window_s


def per_unit_ms(seconds, ctx, unit: str):
    n = ctx["out"].get(unit)
    return None if seconds is None or not n else seconds / n * 1e3


def mfu_percent(ctx):
    """The window's matrix operations at the chip's peaks, over the
    window's time, in percent."""
    bf16, f32 = ctx["cell"].flops()
    need = fl.peak_seconds(bf16, f32)
    return None if need <= 0 else need / ctx["out"]["wall_s"] * 100.0


def roofline_percent(ctx, which: str):
    """A kernel's HBM bound over its device time, over every call of the
    window. The device time is all that ran under the calls' ``pb::k1`` /
    ``pb::k8`` spans: the kernels and what the wrapper issues with them (K1's
    zero fill of its sums). Every call's device kernels have to be in the
    trace: a window that lost records gives no number and fails the run."""
    calls = [c for c in ctx["calls"] if c[0] == which]
    if not calls:
        return None
    recs = ctx["trace"].kernel_records(which)
    if which == "k8":
        want = len(calls)
    else:
        want = sum(tr.K1_KERNELS_PER_CALL[shape["variant"]] for _, shape in calls)
    if len(recs) != want:
        raise RuntimeError(f"the trace kept {len(recs)} device records of {which}, "
                           f"its {len(calls)} calls launched {want}: a window that lost "
                           "records gives no kernel time")
    device_s = ctx["trace"].span_device_s(f"pb::{which}")
    if device_s is None:
        raise RuntimeError(f"the trace holds no device range of pb::{which}, "
                           f"though {len(calls)} calls ran")
    return by.bound_s(calls, which) / device_s * 100.0
