"""Discovery by name: a cell's configuration, mix, limits and metric
readers are files of their own, and a new one is new files plus an entry
in BENCHMARK.json, with no file that exists edited."""

import hashlib
import json
import shutil

import pytest

from perfbench.core import spec
from perfbench.core.common import arch_of
from perfbench.core.spec import ROOT


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert names == ["itc64.train", "itc128.train", "itc64.sample", "itc128.sample"]
    for w in names:
        cell = spec.cell(w)
        assert cell.mode in ("train", "sample")
        assert cell.config["name"] == cell.config_name
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert spec.mode_driver(cell.mode).end_to_end
    with pytest.raises(KeyError):
        spec.cell("no.such")


@pytest.mark.parametrize("block", ["conv", "res", "inception"])
def test_config_arch_selects_the_reference_blocks(block):
    cell = spec.cell("itc64.train")
    cell.config["config"] = dict(cell.config["config"], arch=block)
    assert arch_of(cell).block == block


def test_an_arch_the_reference_lacks_raises():
    cell = spec.cell("itc64.train")
    cell.config["config"] = dict(cell.config["config"], arch="dense")
    with pytest.raises(ValueError, match="no 'dense' blocks"):
        arch_of(cell)


def test_configs_list_what_they_change():
    bench = spec.benchmark()
    for c in bench["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        source = json.loads((ROOT / body["from"]).read_text())
        changed = {k for k in set(source) | set(body["config"])
                   if source.get(k) != body["config"].get(k)}
        assert changed <= set(c["reduced"]), changed - set(c["reduced"])
        assert c["reduced"] == body["reduced"] and c["source"] == body["source"]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "perfbench")
    here = tmp_path / "perfbench"
    cfg = json.loads((here / "configs" / "itc64.json").read_text())
    cfg["name"] = "itc64x"
    (here / "configs" / "itc64x.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train.json").read_text())
    mix["corpus_images"] = 1000
    (here / "traffic" / "train_small.json").write_text(json.dumps(mix))
    (here / "limits" / "itc64x.train_small.json").write_text(
        (here / "limits" / "itc64.train.json").read_text())
    (here / "metrics" / "steps_seen.train.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="itc64x",
                                 file="perfbench/configs/itc64x.json"))
    bench["workloads"].append({"name": "itc64x.train_small", "config": "itc64x",
                               "traffic": "train_small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("itc64x.train_small")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "Device",
                               "moves": "train_img_s", "workloads": ["itc64x.train_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("itc64x.train_small", tmp_path)
    assert cell.config["name"] == "itc64x" and cell.traffic["corpus_images"] == 1000
    assert "steps_seen.train" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("steps_seen.train", tmp_path)(type("R", (), {"units": 7})) == 7.0
    # the old cells are as they were, and no file that was there changed
    assert "steps_seen.train" not in [m["name"] for m in spec.cell("itc64.train", tmp_path).per_layer]
    after = _digest(tmp_path / "perfbench")
    assert all(after[k] == v for k, v in before.items())
