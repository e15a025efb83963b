"""Rehearse the port's doctor preflight end to end on schema-correct archives.

Counterpart of ``analysis/doctor_rehearsal.py`` (the JAX package's). With
no network the real corpora cannot be downloaded, so this writes the
archives the loader tests write (``tests/test_real_corpus_schema.py``:
the real npz key names, dtypes and full factor grids at a reduced stored
resolution) and copies the 5-image Ukiyo-E fixture, then runs
``python -m intro_tc_vae_tpu_torch.doctor``'s ``main`` three ways and
keeps the transcripts a user would see:

1. PASS: dSprites, MPI3D and the Ukiyo-E fixture, laid out as the
   loaders expect;
2. FAIL: a broken layout (the dSprites npz without ``latents_values``;
   the Ukiyo-E image directory absent);
3. FAIL: FID asked for (``--fid``) with no Inception weights file (none
   named by ``ITCVAE_INCEPTION_WEIGHTS`` or at the default path).

The doctor checks the default output directories (``./saves`` is probed
for writing in the working directory; ``log_dir`` is unset), as the JAX
script's runs do. Writes the transcripts to ``--out`` (default
``docs/doctor_rehearsal_torch.txt``; the JAX script's
``docs/doctor_rehearsal.txt`` is its own) and prints them; the last line
is one JSON object with each case's exit code and its report's (status,
check) pairs.

    python -m intro_tc_vae_tpu_torch.analysis.doctor_rehearsal [--out PATH]

Runs the doctor against the card unless ``--device cpu`` (where the
doctor skips its memory check, as the JAX doctor does on a CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DSPRITES_NPZ = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
DSPRITES_FACTORS = [1, 3, 6, 40, 32, 32]
MPI3D_FACTORS = [6, 6, 2, 3, 3, 40, 40]
LINE = re.compile(r"^  (PASS|WARN|FAIL|skip)  (.+?)(?: — .*| \(.*\))?$")


def dsprites_latents_values() -> np.ndarray:
    """The dSprites archive's [737280, 6] factor values on its full grid."""
    grids = [
        np.array([1.0]),
        np.arange(1, 4, dtype=np.float64),
        np.linspace(0.5, 1.0, 6),
        np.linspace(0.0, 2.0 * np.pi, 40),
        np.linspace(0.0, 1.0, 32),
        np.linspace(0.0, 1.0, 32),
    ]
    mesh = np.meshgrid(*grids, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


def synthesize(root: str, broken: bool = False) -> None:
    """The dSprites npz (8x8 images), the MPI3D npz (4x4) and the Ukiyo-E
    fixture under ``root``; ``broken`` drops ``latents_values`` and the
    Ukiyo-E image directory."""
    n = int(np.prod(DSPRITES_FACTORS))
    imgs = (np.random.RandomState(0).rand(n, 8, 8) < 0.2).astype(np.uint8)
    kw = dict(imgs=imgs)
    if not broken:
        kw["latents_values"] = dsprites_latents_values()
    np.savez(os.path.join(root, DSPRITES_NPZ), **kw)

    m = int(np.prod(MPI3D_FACTORS))
    images = np.random.RandomState(1).randint(0, 256, size=(m, 4, 4, 3), dtype=np.uint8)
    np.savez(os.path.join(root, "mpi3d_toy.npz"), images=images)

    fixture = os.path.join(REPO, "tests", "test_data")
    shutil.copy(os.path.join(fixture, "arc_extracted_face_metadata.csv"), root)
    if not broken:
        shutil.copytree(os.path.join(fixture, "arc_extracted_face_images"),
                        os.path.join(root, "arc_extracted_face_images"))


def report_lines(out: str) -> list:
    """(status, check) of every report line of a doctor's output."""
    return [list(m.groups()) for m in map(LINE.match, out.splitlines()) if m]


def run_case(title: str, argv: list, device) -> dict:
    """One doctor run: its transcript, exit code and report lines."""
    from intro_tc_vae_tpu_torch.doctor import main as doctor_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = doctor_main(argv, device=device)
    cmd = "python -m intro_tc_vae_tpu_torch.doctor " + " ".join(
        a if a.startswith("-") else repr(a) for a in argv)
    return {"title": title, "exit": code, "lines": report_lines(buf.getvalue()),
            "transcript": f"$ {cmd}\n{buf.getvalue()}[exit code {code}]   # {title}\n"}


def rehearse(device, work: str) -> list:
    """The JAX script's six cases (its three ways) in ``work``."""
    good, bad = os.path.join(work, "good"), os.path.join(work, "bad")
    os.makedirs(good)
    os.makedirs(bad)
    synthesize(good)
    synthesize(bad, broken=True)
    cases = []
    for name in ("dsprites", "mpi3d", "ukiyo_e64"):
        cases.append(run_case(f"{name}: PASS against the schema-correct layout",
                              ["-u", json.dumps({"dataset": name, "data_root": good})], device))
    cases.append(run_case("dsprites: FAIL — npz missing latents_values",
                          ["-u", json.dumps({"dataset": "dsprites", "data_root": bad})], device))
    cases.append(run_case("ukiyo_e64: FAIL — image directory absent",
                          ["-u", json.dumps({"dataset": "ukiyo_e64", "data_root": bad})], device))
    cases.append(run_case("FID weights: FAIL — --fid with no weights file",
                          ["-u", json.dumps({"dataset": "synthetic"}), "--fid"], device))
    return cases


HEADER = (
    "Doctor rehearsal transcripts (the PyTorch/CUDA port)\n"
    "=====================================================\n"
    "Written by python -m intro_tc_vae_tpu_torch.analysis.doctor_rehearsal against\n"
    "schema-correct archives (tests/test_real_corpus_schema.py's layout: real key\n"
    "names, dtypes and factor grids, fake pixels) and the 5-image Ukiyo-E fixture:\n"
    "what the preflight prints before a user commits to a long run on the real\n"
    "corpora.\n\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "doctor_rehearsal_torch.txt"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    with tempfile.TemporaryDirectory(prefix="itcvae-doctor-") as work:
        cases = rehearse(torch.device(a.device), work)
    text = HEADER + "\n".join(c["transcript"] for c in cases)
    for path in (os.path.join(work, "good"), os.path.join(work, "bad")):
        text = text.replace(path, f"<{os.path.basename(path)}>")
    text = text.replace(work, "<work>")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(text)
    print(text)
    print(f"wrote {a.out}")
    out = {"metric": "doctor_rehearsal", "device": a.device, "out": a.out,
           "cases": [{k: c[k] for k in ("title", "exit", "lines")} for c in cases]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
