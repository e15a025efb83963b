"""What a run may load: modules compared by their whole top-level name,
and the program taken from the checkout only."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.core.spec import ROOT
from perfbench.core import guard


def test_forbidden_names_are_whole_top_level_names():
    loaded = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax.linen": 1,
              "intro_tc_vae_tpu": 1, "intro_tc_vae_tpu.ops.tc": 1,
              "intro_tc_vae_tpu_torch": 1, "intro_tc_vae_tpu_torch.train": 1,
              "jaxtyping": 1, "flaxen": 1, "intro_tc_vae_tpu_torchvision": 1}
    assert guard.forbidden_loaded(loaded) == [
        "flax.linen", "intro_tc_vae_tpu", "intro_tc_vae_tpu.ops.tc", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert guard.top_level("intro_tc_vae_tpu_torch.solvers.graph") == "intro_tc_vae_tpu_torch"


def test_harness_and_program_load_no_jax():
    """Every module a run imports, in a fresh process: nothing forbidden."""
    code = """
import sys, json
sys.path.insert(0, %r)
from perfbench.core import guard, spec
import perfbench.run, perfbench.control, perfbench.reference.flops
import perfbench.modes.train, perfbench.modes.sample
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
guard.import_program(spec.ROOT)
import intro_tc_vae_tpu_torch.train, intro_tc_vae_tpu_torch.models
import intro_tc_vae_tpu_torch.solvers.graph
print(json.dumps(guard.forbidden_loaded()))
""" % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    """Without CUDA (this host) the run exits non-zero and prints nothing."""
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "itc64.train",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_checkout_without_the_program_is_refused(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ holds no port."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(ImportError):
        guard.import_program(tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "itc64.sample",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
