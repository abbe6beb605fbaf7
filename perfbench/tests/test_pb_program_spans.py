"""The readers of the program's own spans: ``frame_inputs_ms.video`` (host
time under ``gf::frame_inputs``) and ``grid_backward_ms.train`` (device time
under ``gf::grid_backward``), on synthetic records and through a traced run
of each cell on the CPU. A program without the spans gives no number."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from conftest import TINY, TINY_LIMITS
from pbcore import trace

NEW = {"head_video": "frame_inputs_ms.video", "head_train": "grid_backward_ms.train",
       "torso_train": "grid_backward_ms.train"}


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


def _reader(harness, name):
    return harness.load_module("metrics", name).read


def _window(extra):
    return [_Event("pb::window", 0, 10_000_000, cpu=True),
            _Event("kernA", 1_000_000, 3_000_000),
            _Event("kernB", 5_000_000, 6_000_000)] + extra


def test_frame_inputs_reads_host_time_per_frame(harness):
    r = trace.Reduced(_prof(_window([
        _Event("gf::frame_inputs", 0, 1_000_000, cpu=True),
        _Event("gf::frame_inputs", 3_000_000, 5_000_000, cpu=True),
        _Event("gf::frame_inputs", 3_100_000, 3_200_000),  # a device range: not host time
    ])))
    ctx = {"trace": r, "out": {"frames": 2}}
    assert _reader(harness, "frame_inputs_ms.video")(ctx) == pytest.approx(1.5)
    # its idle gaps are put down to the span, not to "between spans"
    gaps = dict(r.breakdown()["idle_gaps"])
    assert gaps["gf::frame_inputs"] == pytest.approx(3e-3)  # 0..1 ms, 3..5 ms


def test_grid_backward_reads_device_time_per_step(harness):
    r = trace.Reduced(_prof(_window([
        _Event("gf::backward", 500_000, 6_500_000, cpu=True),
        _Event("gf::grid_backward", 2_000_000, 6_000_000, cpu=True),  # autograd's thread
        _Event("gf::grid_backward", 2_500_000, 5_500_000),  # its device range
    ])))
    ctx = {"trace": r, "out": {"steps": 4}}
    # busy under 2.5..5.5 ms: kernA 2.5..3, kernB 5..5.5
    assert _reader(harness, "grid_backward_ms.train")(ctx) == pytest.approx(0.25)
    gaps = dict(r.breakdown()["idle_gaps"])
    assert gaps["gf::grid_backward"] == pytest.approx(2e-3)  # 3..5 ms
    # a gap goes to the span open where it starts: 6..10 ms opens under gf::backward
    assert gaps["gf::backward"] == pytest.approx(4e-3)


def test_grid_backward_takes_in_the_scatters_it_called(harness):
    """The K1 calls made inside the span count with it, though their kernels
    are the benchmark's ``pb::k1`` spans' (the innermost span takes them); a
    call made outside it does not."""
    r = trace.Reduced(_prof(_window([
        _Event("gf::grid_backward", 500_000, 2_000_000, cpu=True),
        _Event("pb::k1", 1_500_000, 1_800_000, cpu=True),  # called inside
        _Event("pb::k1", 2_500_000, 2_600_000, cpu=True),  # called after it
        _Event("gf::grid_backward", 1_000_000, 2_000_000),  # its own kernels end at 2 ms
        _Event("pb::k1", 2_000_000, 2_500_000),  # the first call's kernels
        _Event("pb::k1", 5_000_000, 5_200_000),  # the second call's
    ])))
    ctx = {"trace": r, "out": {"steps": 1}}
    assert _reader(harness, "grid_backward_ms.train")(ctx) == pytest.approx(1.5)  # 1..2.5 ms
    lost = trace.Reduced(_prof(_window([  # a call's device range missing: its own range alone
        _Event("gf::grid_backward", 500_000, 2_000_000, cpu=True),
        _Event("pb::k1", 1_500_000, 1_800_000, cpu=True),
        _Event("gf::grid_backward", 1_000_000, 2_000_000),
    ])))
    assert _reader(harness, "grid_backward_ms.train")({"trace": lost, "out": {"steps": 1}}) \
        == pytest.approx(1.0)


@pytest.mark.parametrize("name, unit", [("frame_inputs_ms.video", "frames"),
                                        ("grid_backward_ms.train", "steps")])
def test_a_program_without_the_span_gives_no_number(harness, name, unit):
    """The parent's program has neither span: the reader returns nothing and
    the line leaves the metric out."""
    ctx = {"trace": trace.Reduced(_prof(_window([]))), "out": {unit: 3}}
    assert _reader(harness, name)(ctx) is None


class _CpuAsDevice:
    """A CPU-only profile whose operators, ``gf::grid_backward`` and ``pb::k1``
    ranges are also given as device records: the CPU stands in for the card's
    timeline, so the device readers have something to read."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._p = profile(activities=[ProfilerActivity.CPU])

    def __enter__(self):
        self._p.__enter__()
        return self

    def __exit__(self, *exc):
        return self._p.__exit__(*exc)

    @property
    def profiler(self):
        events = []
        for e in self._p.profiler.kineto_results.events():
            events.append(e)
            name = e.name()
            if name in ("gf::grid_backward", "pb::k1") or name.startswith("aten::"):
                events.append(_Event(name, e.start_ns(), e.start_ns() + e.duration_ns()))
        return SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))


@pytest.mark.parametrize("cell", ["head_video", "head_train", "torso_train"])
def test_a_traced_cpu_run_reports_the_new_metric(harness, monkeypatch, cell):
    monkeypatch.setattr(trace, "profile", _CpuAsDevice)
    monkeypatch.setattr(trace, "open_window", lambda: None)
    spec = harness.cell_spec(cell)
    spec = dict(spec, limits=TINY_LIMITS[cell],
                per_layer=[m for m in spec["per_layer"] if m["name"] == NEW[cell]])
    assert len(spec["per_layer"]) == 1
    res = harness.run_cell(spec, 2**31 + 17, 0.5, True, device="cpu", config_over=TINY)
    assert res["correct"], res["checks"]
    assert res["metrics"][NEW[cell]]["value"] > 0
