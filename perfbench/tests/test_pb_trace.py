"""The per-layer arithmetic on synthetic records: the union of busy
intervals, the device time under a span, the idle gaps by host span, the
kernels' record counts, and the tail over all requests."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from pbcore import readers, trace


class _Event:
    def __init__(self, name, start, end, cpu=False):
        self._n, self._s, self._d = name, start, end - start
        self._t = DeviceType.CPU if cpu else DeviceType.CUDA

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _window():
    return [
        _Event("pb::window", 0, 1000, cpu=True),
        _Event("gf::field", 100, 400, cpu=True),
        _Event("gf::field", 150, 500),  # its range on the device timeline
        _Event("kernA", 150, 300),
        _Event("kernB", 250, 350),  # overlaps kernA: counted once
        _Event("gather_rows_vec4_kernel<float>", 400, 450),
        _Event("walk_rows_kernel<float, 4>", 700, 800),
        _Event("spin_kernel", 0, 50),  # the window's opening launches: left out
        _Event("kernC", 1100, 1200),  # after the window: left out
    ]


def test_busy_union_and_idle():
    r = trace.Reduced(_prof(_window()))
    assert r.busy == [(150, 350), (400, 450), (700, 800)]
    assert r.busy_s == 350e-9 and r.window_s == 1000e-9
    assert readers.idle_share({"trace": r}) == pytest.approx(0.65)


def test_span_device_time_counts_busy_time_inside_the_range():
    r = trace.Reduced(_prof(_window()))
    assert r.span_device_s("gf::field") == pytest.approx(250e-9)  # 150..350 and 400..450
    assert r.span_device_s("gf::march") is None
    assert r.host_span_s("gf::field") == pytest.approx(300e-9)


def test_idle_gaps_by_host_span():
    gaps = dict(trace.Reduced(_prof(_window())).breakdown()["idle_gaps"])
    assert gaps["gf::field"] == pytest.approx(50e-9)  # 350..400
    assert gaps["host: between spans"] == pytest.approx(600e-9)  # 0..150, 450..700, 800..1000


def test_roofline_needs_every_record():
    """A kernel's time is all the device ran under its calls' spans (K1's
    zero fill with its kernel), and a window that lost a record gives none."""
    r = trace.Reduced(_prof(_window() + [
        _Event("pb::k8", 400, 450),
        _Event("pb::k1", 650, 800),
        _Event("vectorized_elementwise_kernel<FillFunctor<float>>", 650, 690),
    ]))
    k8 = ("k8", dict(M=1000, W=8, R=10, itemsize=4))
    ctx = {"trace": r, "calls": [k8]}
    assert readers.roofline_percent(ctx, "k8") == pytest.approx(
        (4000 + 320 + 32000) / 3.35e12 / 50e-9 * 100)
    with pytest.raises(RuntimeError, match="lost records"):
        readers.roofline_percent({"trace": r, "calls": [k8, k8]}, "k8")
    k1 = ("k1", dict(M=10, W=4, R=5, itemsize=4, variant="vec"))
    assert readers.roofline_percent({"trace": r, "calls": [k1]}, "k1") == pytest.approx(
        (40 + 160 + 80) / 3.35e12 / 140e-9 * 100)  # the fill's 40 ns and the kernel's 100
    with pytest.raises(RuntimeError):  # `sorted` launches five kernels
        readers.roofline_percent({"trace": r, "calls": [("k1", dict(k1[1], variant="sorted"))]}, "k1")
    assert readers.roofline_percent({"trace": r, "calls": []}, "k1") is None
    bare = trace.Reduced(_prof(_window()))  # the records, but no span around the call
    with pytest.raises(RuntimeError, match="no device range"):
        readers.roofline_percent({"trace": bare, "calls": [k8]}, "k8")


@pytest.mark.parametrize("lat, want_ms", [
    ([0.05] * 95 + [0.5] * 5, 50.0 + 0.05 * 450.0),  # rank 94.05 of 100
    ([0.01 * k for k in range(1, 201)], 1900.0 + 0.05 * 10.0),  # rank 189.05
    ([0.2] * 19 + [3.0], 0.2e3 + 0.05 * 2.8e3),
])
def test_p95_over_all_requests(lat, want_ms):
    """The viewer's tail is the 95th percentile of every request's latency,
    not a median of chunks: one slow request moves it."""
    assert readers.p95_ms(lat) == pytest.approx(want_ms)
    assert readers.p95_ms(lat) == pytest.approx(np.percentile(np.asarray(lat), 95) * 1e3)
