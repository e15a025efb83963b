"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell; its configuration, traffic mix, limits and per-layer
metric readers are files of their own under ``perfbench/``, found by the
names ``BENCHMARK.json`` gives them:

* ``configs/<config>.json``: the repo configuration it comes from, each
  key it changes, ``reduced``, ``assumed``, its ``source``, and the whole
  configuration as run (``config``) with the model's shape (``model``).
  ``config.arch`` selects the reference's blocks (``conv``, ``res`` or
  ``inception``, ``reference/model.py::BLOCKS``); the reference has the
  ``intro_tc`` step only, so ``config.solver`` is ``intro_tc``;
* ``traffic/<traffic>.json``: ``mode`` (``train`` or ``sample``, the
  driver ``modes/<mode>.py``) and its parameters;
* ``limits/<workload>.json``: each number the comparison reads, with its
  limit;
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A new cell, mix or metric is new files and an entry in ``BENCHMARK.json``;
no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parents[1]  # perfbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: dict           # configs/<config>.json
    traffic_name: str
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # limits/<workload>.json
    end_to_end: list       # the end-to-end metric entries this cell reports
    per_layer: list        # the per-layer metric entries this cell reports

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: ``root``'s
    ``BENCHMARK.json``); raises ``KeyError`` for an unknown name."""
    bench = benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {[w['name'] for w in bench['workloads']]})")
    here = root / "perfbench"
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, workload) and m["moves"] in e2e_names]
    return Cell(name=workload, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=read_json(here / "configs" / f"{entry['config']}.json"),
                traffic_name=entry["traffic"],
                traffic=read_json(here / "traffic" / f"{entry['traffic']}.json"),
                limits=read_json(here / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer)


def load_module(path: Path, name: str):
    """Import the Python file at ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(metric: str, root: Path = ROOT):
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    safe = "".join(c if c.isalnum() else "_" for c in metric)
    return load_module(path, f"perfbench_metric_{safe}").read


def mode_driver(mode: str):
    """The driver module of a traffic mode, ``perfbench/modes/<mode>.py``."""
    return importlib.import_module(f"perfbench.modes.{mode}")
