"""The harness finds every part of a cell by name, and a later change adds
a configuration, a cell, a traffic mix or a per-layer metric by adding
files alone."""

import json
import os
import shutil

import pytest

from conftest import HERE, TINY


def _bench():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["head_train", "head_video", "torso_train", "torso_live"])
def test_cell_parts_are_found_by_name(harness, cell):
    spec = harness.cell_spec(cell)
    assert os.path.exists(os.path.join(HERE, "configs", f"{spec['config']}.json"))
    mix = harness.read_json(os.path.join(HERE, "traffic", f"{spec['traffic']}.json"))
    assert os.path.exists(os.path.join(HERE, "drivers", f"{mix['driver']}.py"))
    assert spec["end_to_end"] and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    # every limit is of a number that the cell's check reads; one without a limit is
    # read and printed, not compared
    assert spec["limits"] and set(spec["limits"]) <= set(_numbers(mix["driver"]))


def _numbers(driver):
    return {"train": ["loss_rel_gap", "grad1_leaf_gap", "change_leaf_gap", "batch_pixel_levels",
                      "window_loss_rel_gap", "window_grad1_leaf_gap", "window_change_leaf_gap",
                      "head_frozen_gap"],
            "video": ["frame_rgb_gap", "frame_u8_exact"],
            "live": ["frame_rgb_gap", "frame_u8_exact"]}[driver]


def test_benchmark_json_meets_its_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "workloads", f"{w['name']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert sum(m["name"] == "setup_s" for m in bench["end_to_end"]) == 1


def test_a_later_cell_is_whole_and_apart():
    """A cell kept in ``perfbench/later/`` (built, not yet measured on the
    card) has its workload file and readers, and takes no name that
    ``BENCHMARK.json`` uses."""
    from conftest import bench_with_later

    bench, merged = _bench(), bench_with_later()
    for key in ("workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in merged[key]]
        assert len(names) == len(set(names))
    added = {w["name"] for w in merged["workloads"]} - {w["name"] for w in bench["workloads"]}
    assert added == {"torso_live"}
    for m in merged["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py"))
    for w in added:
        assert os.path.exists(os.path.join(HERE, "workloads", f"{w}.json"))


def test_a_cell_added_as_files_alone_runs(harness, monkeypatch, tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric as new files (and new entries); no file of the copy changes, and
    the new cell runs through the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    (root / "perfbench" / "traffic" / "video_short.json").write_text(json.dumps(
        {"driver": "video", "clip_frames": [3, 5], "warm_frames": 2, "motion_std": 0.1,
         "why": "short clips"}))
    (root / "perfbench" / "workloads" / "head_video_short.json").write_text(json.dumps(
        {"config": "radnerf_head", "traffic": "video_short", "why": "short clips",
         "limits": {"frame_rgb_gap": 1e-4, "frame_u8_exact": 0.0}}))
    (root / "perfbench" / "metrics" / "clips.video.py").write_text(
        '"""Clips rendered in the window."""\n\n\ndef read(ctx):\n    return ctx["out"]["clips"]\n')
    bench = _bench()
    bench["workloads"].append({"name": "head_video_short", "config": "radnerf_head",
                               "traffic": "video_short", "chips": 1, "why": "short clips"})
    bench["end_to_end"][1]["workloads"].append("head_video_short")
    bench["per_layer"].append({"name": "clips.video", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "Entry",
                               "moves": "video_frame_ms", "workloads": ["head_video_short"]})
    from pbcore import scene

    monkeypatch.setattr(harness, "HERE", str(root / "perfbench"))
    monkeypatch.setattr(scene, "ROOT", str(root / "perfbench"))
    spec = harness.cell_spec("head_video_short", bench)
    assert [m["name"] for m in spec["per_layer"]] == ["clips.video"]
    res = harness.run_cell(spec, 2**31 + 5, 0.5, False, device="cpu", config_over=TINY)
    assert res["correct"] and res["attempted"] >= 3
    assert set(res["metrics"]) == {"video_frame_ms", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
    assert harness.load_module("metrics", "clips.video").read({"out": {"clips": 4}}) == 4
