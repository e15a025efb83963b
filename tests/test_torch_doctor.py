"""PyTorch port vs JAX package: the doctor preflight
(``intro_tc_vae_tpu_torch/doctor.py`` against ``intro_tc_vae_tpu/doctor.py``).

Every scenario of tests/test_doctor.py, and an output directory that
cannot be written, runs through both doctors on the same synthesized
inputs; their exit codes and the (status, check) pair of every report line
must be equal. The port's doctor is given the CPU, where it skips the
memory estimate as the JAX doctor does on a CPU. Two cases are the port's
own: without CUDA the default device fails the device check, and the
entry point imports neither jax nor the JAX package.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.doctor import main as jax_doctor
from intro_tc_vae_tpu_torch import doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_DATA = os.path.join(REPO, "tests", "test_data")
CPU = torch.device("cpu")
LINE = re.compile(r"^  (PASS|WARN|FAIL|skip)  (.+?)(?: — .*| \(.*\))?$")


def _lines(out: str) -> list:
    """(status, check) of every report line, and the section headers."""
    pairs = []
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            pairs.append(m.groups())
        elif line.startswith("["):
            pairs.append(("section", line))
    return pairs


def _both(capsys, update: dict, *extra: str):
    """(exit code, lines) of the JAX doctor and of the port's, same argv."""
    argv = ["-u", json.dumps(update), *extra]
    rc_j = jax_doctor(argv)
    out_j = capsys.readouterr().out
    rc_p = doctor.main(argv, device=CPU)
    out_p = capsys.readouterr().out
    return (rc_j, _lines(out_j)), (rc_p, _lines(out_p)), out_p


def _dirs(tmp_path) -> dict:
    return {"checkpoint_dir": str(tmp_path / "ck"), "log_dir": str(tmp_path / "tb")}


def _dsprites_root(tmp_path, name: str, **arrays):
    root = tmp_path / name
    root.mkdir()
    np.savez(root / "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz", **arrays)
    return str(root)


def _scenarios(tmp_path) -> dict:
    """Each scenario's (update, extra argv, expected exit code, a line the
    port's report must hold); tests/test_doctor.py's, and an unwritable
    output directory."""
    ukiyo_no_images = tmp_path / "ukiyo"
    ukiyo_no_images.mkdir()
    shutil.copy(os.path.join(TEST_DATA, "arc_extracted_face_metadata.csv"), ukiyo_no_images)
    np.savez(tmp_path / "mpi3d_toy.npz", images=np.zeros((4, 64, 64), np.uint8))
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    base = dict(solver="vae", dataset="synthetic", **_dirs(tmp_path))
    return {
        "synthetic passes": (base, (), 0, "WARN  weights file"),
        "fid without weights fails": (
            base, ("--fid", "--inception-weights", str(tmp_path / "nope.pth")), 1,
            "FAIL  weights file"),
        "invalid config fails fast": (
            dict(solver="vae", dataset="synthetic", remat="Block"), (), 1, "FAIL  config"),
        "dsprites valid": (
            dict(base, dataset="dsprites", data_root=_dsprites_root(
                tmp_path, "good", imgs=np.zeros((4, 64, 64), np.uint8),
                latents_values=np.zeros((4, 6)))), (), 0, "WARN  dSprites row count"),
        "dsprites repacked": (
            dict(base, dataset="dsprites", data_root=_dsprites_root(
                tmp_path, "bad", images=np.zeros((4, 64, 64), np.uint8))), (), 1,
            "FAIL  dSprites key 'imgs'"),
        "dsprites absent": (
            dict(base, dataset="dsprites", data_root=str(tmp_path)), (), 1,
            "FAIL  dSprites archive"),
        "mpi3d wrong ndim": (
            dict(base, dataset="mpi3d", data_root=str(tmp_path)), (), 1,
            "FAIL  MPI3D key 'images'"),
        "ukiyo_e fixture passes": (
            dict(base, solver="intro", dataset="ukiyo_e64", data_root=TEST_DATA), (), 0,
            "PASS  Ukiyo-E decode probe"),
        "ukiyo_e without images fails": (
            dict(base, solver="intro", dataset="ukiyo_e64", data_root=str(ukiyo_no_images)),
            (), 1, "FAIL  Ukiyo-E images"),
        "unwritable output dir fails": (
            dict(base, checkpoint_dir=str(blocker / "ck")), (), 1, "FAIL  checkpoint_dir"),
    }


SCENARIOS = ("synthetic passes", "fid without weights fails", "invalid config fails fast",
             "dsprites valid", "dsprites repacked", "dsprites absent", "mpi3d wrong ndim",
             "ukiyo_e fixture passes", "ukiyo_e without images fails",
             "unwritable output dir fails")


@pytest.mark.parametrize("name", SCENARIOS)
def test_doctor_matches_jax(tmp_path, capsys, monkeypatch, name):
    """Exit code and (status, check) of every line equal to the JAX
    doctor's; the memory line on the CPU is ``skip  memory estimate (cpu:
    no memory_stats)`` in both."""
    monkeypatch.delenv("ITCVAE_INCEPTION_WEIGHTS", raising=False)
    update, extra, rc, line = _scenarios(tmp_path)[name]
    (rc_j, lines_j), (rc_p, lines_p), out = _both(capsys, update, *extra)
    assert lines_p == lines_j
    assert rc_p == rc_j == rc, out
    assert line in out
    if name != "invalid config fails fast":  # that one stops after the config
        assert "  skip  memory estimate (cpu: no memory_stats)" in out


@pytest.fixture(scope="module")
def inception_file(tmp_path_factory):
    """A random InceptionV3 state_dict of the port's model, torchvision
    names, saved as a .pth (what a round trip of real weights gives)."""
    from intro_tc_vae_tpu_torch.models.inception import InceptionV3Features

    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("inception") / "inception.pth"
    torch.save(InceptionV3Features().state_dict(), path)
    return str(path)


@pytest.mark.parametrize("which", ["round trip passes", "junk fails"])
def test_inception_weights_check_matches_jax(tmp_path, capsys, inception_file, which):
    """A state_dict with the inception_v3 trunk's names and shapes passes
    the structure check in both doctors (with --fid); a junk state_dict
    fails it in both, with the same count of missing params."""
    if which == "junk fails":
        path = str(tmp_path / "junk.pth")
        torch.save({"Conv2d_1a_3x3.conv.weight": torch.zeros(32, 3, 3, 3)}, path)
        extra, rc, line = ("--inception-weights", path), 1, "FAIL  weights structure"
    else:
        extra, rc, line = (("--inception-weights", inception_file, "--fid"), 0,
                           "PASS  weights structure")
    (rc_j, lines_j), (rc_p, lines_p), out = _both(
        capsys, dict(solver="vae", dataset="synthetic", **_dirs(tmp_path)), *extra)
    assert lines_p == lines_j
    assert rc_p == rc_j == rc, out
    assert line in out
    from intro_tc_vae_tpu_torch.models.inception import InceptionV3Features

    n_params = len(list(InceptionV3Features().parameters()))
    assert (f"{n_params - 1} missing params" if rc
            else f"all {n_params} param tensors present") in out


def test_default_device_without_cuda_fails(tmp_path, capsys, monkeypatch):
    """The default device on a host without CUDA: ``FAIL  device`` with a
    fix and exit 1, never a silent skip."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = doctor.main(["-u", json.dumps(dict(solver="vae", dataset="synthetic",
                                            **_dirs(tmp_path)))])
    out = capsys.readouterr().out
    assert rc == 1
    assert "  FAIL  device — torch.cuda.is_available() is false" in out
    assert "fix:" in out.split("FAIL  device", 1)[1]
    assert "result: FAIL" in out


def test_activation_estimate_is_the_jax_formula():
    """The flagship (64 px, bf16) at batch 64: 983,040 activations a
    sample a pass, x 2 bytes x 7 passes x 2 = 1,680 MiB; remat "pass"
    keeps 2 passes (480 MiB); fp32 doubles it; ukiyo_e256 takes six levels."""
    from intro_tc_vae_tpu_torch.config import load_config

    flagship = os.path.join(REPO, "configs", "intro_tc_ukiyo64.json")

    def mib(**update):
        est, _ = doctor.activation_estimate(load_config(flagship, update))
        return est / 2**20

    assert mib() == 1680 and mib(remat="pass") == 480
    assert mib(precision="fp32") == 3360 and mib(batch_size=256) == 6720
    assert doctor.activation_estimate(load_config(flagship, {"dataset": "ukiyo_e256"}))[1] == 256


def test_entry_point_imports_no_jax(tmp_path):
    """``python -m intro_tc_vae_tpu_torch.doctor`` run in a fresh
    interpreter (as runpy runs ``-m``) leaves no jax and nothing of the JAX
    package in ``sys.modules``; without a card it fails the device check."""
    update = json.dumps(dict(solver="vae", dataset="synthetic", **_dirs(tmp_path)))
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['doctor', '-u', {update!r}]\n"
        "try:\n"
        "    runpy.run_module('intro_tc_vae_tpu_torch.doctor', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'intro_tc_vae_tpu'))\n"
        "print('RESULT', json.dumps({'rc': rc, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.split("RESULT", 1)[1])
    assert result["bad"] == []
    assert result["rc"] == 1
    assert "FAIL  device" in out.stdout

