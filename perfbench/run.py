"""Run one cell of the benchmark of ``geneface_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json`` and
``perfbench/workloads/<cell>.json`` (its limits), the configuration in
``perfbench/configs/<config>.json``, the traffic mix in
``perfbench/traffic/<traffic>.json``, which names its driver in
``perfbench/drivers/<driver>.py``, and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``.

The run builds the cell's scene from the seed and warms it up (set-up),
measures for ``--seconds``, then checks what the window produced against the
plain reference in ``perfbench/reference/``. With ``--trace 0`` it reports
the cell's end-to-end metrics; with ``--trace 1`` it runs the window under
``torch.profiler`` and reports the per-layer metrics. The last line of
standard output is one JSON object; the numbers compared and their limits
close standard error. ``--control`` runs the program at the nearest lower
precision that it offers (bfloat16 grids) and reports the same comparison:
that run has to come out not correct.

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level modules that no run may hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geneface_tpu")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pb_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """The cell's entry in ``BENCHMARK.json`` joined with its workload file,
    its end-to-end and per-layer metrics."""
    bench = bench or read_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = read_json(os.path.join(HERE, "workloads", f"{name}.json"))
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"workloads/{name}.json disagrees with BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return dict(entry, limits=wl.get("limits", {}), end_to_end=e2e, per_layer=layer)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare_env() -> None:
    """Every cache of the run inside the checkout, at fixed paths; nothing
    that loads JAX; one thread for the CPU's parallel regions (before
    ``torch`` is imported: :mod:`pbcore.host`)."""
    from pbcore import host

    host.limit_threads(1)
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", patch=None, config_over: dict | None = None,
             faults: bool = False) -> dict:
    """One run of a cell → the result object (and ``checks``, the numbers
    compared). ``device`` ``cpu`` and ``patch`` (called with the built cell
    before its window) serve the tests; the command line takes the card."""
    import torch

    from pbcore import host, scene, trace as tr
    from pbcore.calls import recording

    cfg = scene.config(spec["config"])
    cfg.update(config_over or {})
    if control:
        cfg.update(grid_compute_dtype="bf16", grid_bwd_dtype="bf16")
    mix = read_json(os.path.join(HERE, "traffic", f"{spec['traffic']}.json"))
    driver = load_module("drivers", mix["driver"])
    cell = driver.Cell(cfg, mix, int(seed), torch.device(device))
    cell.setup()
    if patch is not None:
        patch(cell)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.3f} s", file=sys.stderr)
    calls, reduced = [], None
    threads0 = host.threads()
    if trace:
        with tr.profile() as prof:
            tr.open_window()
            with recording(calls), torch.profiler.record_function("pb::window"):
                out = cell.window(seconds, traced=True)
        reduced = tr.Reduced(prof)
    else:
        out = cell.window(seconds, traced=False)
    print(f"host in the window: {host.delta(threads0, host.threads())}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics = {}
    if trace:
        ctx = dict(cell=cell, out=out, trace=reduced, calls=calls, cfg=cfg)
        for m in spec["per_layer"]:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        vals = dict(out["end_to_end"], setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(vals[m["name"]]), "unit": m["unit"]}
    cell.release()
    t_check = time.perf_counter()
    # a number that the cell's workload file gives no limit is read, not compared
    numbers = cell.check(spec["limits"])
    checks = [c for c in numbers if c["name"] in spec["limits"]]
    readings = [c for c in numbers if c["name"] not in spec["limits"]]
    print(f"window {out['wall_s']:.3f} s, check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    if faults and hasattr(cell, "fault_readings"):
        for name, nums in cell.fault_readings().items():
            print(f"fault {name}: {json.dumps(nums)}", file=sys.stderr)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks),
        "attempted": int(out["attempted"]), "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": 1, "memory_peak_bytes": int(peak)},
        "checks": checks,
        "readings": readings,
    }
    if reduced is not None:
        result["device"].update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        result["breakdown"] = reduced.breakdown()
    return result


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true",
                    help="also print the numbers with each fault planted in the reference")
    args = ap.parse_args(argv)
    prepare_env()
    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"nvidia-smi: {power_limit()}", file=sys.stderr)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), args.control,
                      faults=args.faults)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}: no result", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for c in result.pop("readings"):
        print(f"not compared {c['name']}: {c['value']!r}", file=sys.stderr)
    # the numbers compared, each beside its limit, as the line's last key
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"compared {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
