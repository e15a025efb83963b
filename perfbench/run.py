"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 perfbench/run.py --workload itc64.train --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds the port (``intro_tc_vae_tpu_torch``).
The run makes its inputs from ``--seed``, sets the program up and warms it
(``setup_s``, from this file's first line to the window's start), measures
for ``--seconds``, then checks the window's outputs against the plain
reference (``perfbench/reference/``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones, from a profiler over a steady stretch of the window),
``device``, ``breakdown`` (``--trace 1``) and ``checks``, each compared
number beside its limit, which also end standard error.

It exits non-zero and prints no result when the card is missing or has
fewer devices than the cell asks for, when the port is not in the
checkout, or when JAX, flax or the JAX package has been loaded. Build and
kernel caches go to fixed directories under ``build/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache", "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


class Refused(Exception):
    """A run that prints no result."""


def set_environment(root: Path) -> None:
    """Every cache the program or its libraries keep, at a fixed path in
    the checkout; no library loads JAX on its own."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "perfbench" / sub)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description="run one cell of BENCHMARK.json once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the limits name
    is finite and at or under its limit."""
    shown, correct = {}, True
    for name, entry in limits["checks"].items():
        value = checks.get(name, math.inf)
        limit = entry["limit"]
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        shown[name] = {"value": value, "limit": limit}
    return correct, shown


def run(args, root: Path = ROOT) -> dict:
    sys.path.insert(0, str(root))
    from perfbench.core import guard, spec

    try:
        cell = spec.cell(args.workload, root)
    except (KeyError, FileNotFoundError) as e:
        raise Refused(f"cell: {e}")
    marks = {"start_import_torch": time.perf_counter() - T_START}
    import torch

    marks["start_cuda"] = time.perf_counter() - T_START
    if not torch.cuda.is_available():
        raise Refused("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {cell.chips}")
    torch.cuda.init()
    marks["start_program_import"] = time.perf_counter() - T_START
    try:
        guard.import_program(root)
    except ImportError as e:
        raise Refused(f"the program: {e}")
    marks["start_build"] = time.perf_counter() - T_START
    from perfbench.core.profiled import warm_up
    from perfbench.core.readings import Readings

    torch.set_num_threads(4)
    device = torch.device("cuda:0")
    driver = spec.mode_driver(cell.mode)
    with contextlib.redirect_stdout(sys.stderr):  # the program's own prints
        if args.trace:
            warm_up(device)
        session = driver.build(cell, args.seed, device)
        setup_s = time.perf_counter() - T_START
        win = driver.window(session, args.seconds, bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device)
    loaded = guard.forbidden_loaded()
    if loaded:
        raise Refused(f"loaded in this process: {', '.join(loaded)}")

    units = win.units
    readings = Readings(cell=cell, arch=session.arch, batch=session.batch,
                        units=units, lo=win.lo, hi=win.hi,
                        spans=session.spans, trace=win.trace, trace_units=win.trace_units,
                        traced=win.traced,
                        precision=cell.config["config"]["precision"])
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(win), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    driver.free(session)
    with contextlib.redirect_stdout(sys.stderr):
        checks = driver.check(session)
    correct, shown = judge(checks, cell.limits)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
           "device": dev}
    if args.trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s
        out["breakdown"] = {"device_ops": win.trace.by_name(10),
                            "idle_gaps": win.trace.idle_gaps(10)}
    out["checks"] = shown
    setup = {n: round(b - a, 3) for n, a, b in session.spans.records if n.startswith("setup_")}
    marks = {k: round(v, 3) for k, v in marks.items()}
    out["_detail"] = dict({k: v for k, v in checks.items() if k not in shown}, **marks, **setup)
    return out


def main(argv=None) -> int:
    set_environment(ROOT)
    args = parse(argv)
    try:
        out = run(args)
    except Refused as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    detail = out.pop("_detail")
    checks = out.pop("checks")
    out["checks"] = checks  # the last key of the line
    print(f"perfbench: {args.workload} seed {args.seed}: detail {json.dumps(detail)}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
