"""On the card (marker ``cuda``): the faults and the control of
test_pb_faults.py through the graphed step, at the cell's own size and
limits (real CUDA graphs: the stale batch shows in the replays alone),
and through the graphed serving pass at synthetic_small widths; and one
whole run of a cell, short. Run there with
``python -m pytest -q -m cuda perfbench/tests``."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.core import spec
from perfbench.core.spec import ROOT
from test_pb_faults import sample_run, train_run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_train_faults_on_the_card(card):
    cell = spec.cell("itc64.train")
    ok, checks = train_run(cell, 31, card)
    assert ok, checks
    for fault in ("unchanged", "half_batch", "stale_batch"):
        assert not train_run(cell, 31, card, fault=fault)[0], fault
    assert not train_run(cell, 31, card, stand_in="fp8")[0]


@pytest.mark.cuda
def test_sample_fault_on_the_card(card, small):
    cell = small("itc64.sample")
    cell.config["config"]["precision"] = "bf16"
    assert sample_run(cell, 32, card)[0]
    assert not sample_run(cell, 32, card, alter=True)[0]


@pytest.mark.cuda
def test_a_whole_run(card):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "itc64.sample",
                        "--seed", "33", "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "checks"
    assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
