"""Doctor: preflight a real-data training run of the port.

    python -m intro_tc_vae_tpu_torch.doctor -f config.json -u '{"dataset": "ukiyo_e256"}'
    python -m intro_tc_vae_tpu_torch.doctor -u '{"dataset": "dsprites", "data_root": "/data"}' \
        --inception-weights /path/pt_inception-2015-12-05.pth

Counterpart of ``intro_tc_vae_tpu/doctor.py`` (``itcvae-doctor``), with
its arguments, sections, PASS/WARN/FAIL/skip lines, fixes and exit codes:
0 when every check passed or was skipped as not applicable, 1 when any
failed. It checks the config (the port's ``load_config``), the corpus
layout the loaders assume (npz keys and ndims from the headers alone, the
Ukiyo-E CSV through ``UkiyoE.load_labels``, its image directory and one
decode), the Inception weights file against ``InceptionV3Features``, the
card's free memory against a coarse estimate of the step's activations,
and the output directories.

The memory check runs on the card, ``cuda:0`` unless ``main`` is given
another device: ``torch.cuda.mem_get_info`` gives the free and total bytes,
and the estimate is the JAX doctor's formula with its thresholds (FAIL
over the free bytes, WARN over 0.7 of them). It is a ballpark that counts
activations only, well under the measured peak of a step
(``chip_smoke.py`` phase 13 prints the two side by side; ROADMAP, known
differences). Without CUDA the check fails, unless the caller passes a
CPU device, which has no memory figures: then it is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

# npz archives the loaders open, with the keys/shapes they index
# (reference dataset.py:56-57 ["imgs"]*255 / ["latents_values"];
# :136 ["images"]). Row counts are the full public corpora.
_DSPRITES_FILE = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
_MPI3D_FILE = "mpi3d_toy.npz"
_UKIYOE_CSV = "arc_extracted_face_metadata.csv"
_UKIYOE_DIR = "arc_extracted_face_images"


class _Report:
    """Collects PASS/WARN/FAIL lines; FAILs flip the exit code."""

    def __init__(self) -> None:
        self.failed = False

    def ok(self, check: str, detail: str = "") -> None:
        print(f"  PASS  {check}" + (f" — {detail}" if detail else ""))

    def warn(self, check: str, detail: str, fix: str = "") -> None:
        print(f"  WARN  {check} — {detail}")
        if fix:
            print(f"        fix: {fix}")

    def fail(self, check: str, detail: str, fix: str) -> None:
        self.failed = True
        print(f"  FAIL  {check} — {detail}")
        print(f"        fix: {fix}")

    def skip(self, check: str, why: str) -> None:
        print(f"  skip  {check} ({why})")


def _npz_headers(path: str) -> Iterator[Tuple[str, tuple, np.dtype]]:
    """(key, shape, dtype) for each array in an npz without reading the
    data: only each member's .npy header, so a 3 GB corpus takes
    milliseconds. Through numpy's public header readers (format versions
    1.0 and 2.0; the JAX doctor's private ``_read_array_header`` is gone
    from numpy 2's ``numpy.lib.format``); another version is a ValueError."""
    from numpy.lib import format as npfmt

    readers = {(1, 0): npfmt.read_array_header_1_0, (2, 0): npfmt.read_array_header_2_0}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if not name.endswith(".npy"):
                continue
            with zf.open(name) as f:
                version = npfmt.read_magic(f)
                if version not in readers:
                    raise ValueError(f"{name}: .npy format version {version}")
                shape, _fortran, dtype = readers[version](f)
                yield name[:-4], shape, dtype


def _check_npz(rep: _Report, path: str, want: dict, expected_rows: int,
               corpus: str) -> None:
    if not os.path.exists(path):
        rep.fail(
            f"{corpus} archive", f"{path} not found",
            f"download {os.path.basename(path)} into data_root "
            "(or pass --data-root / config.data_root)",
        )
        return
    try:
        headers = {k: (shape, dtype) for k, shape, dtype in _npz_headers(path)}
    except (zipfile.BadZipFile, ValueError) as e:
        rep.fail(f"{corpus} archive", f"unreadable npz: {e!r}",
                 "re-download the archive; it is corrupt or not an npz")
        return
    for key, ndim in want.items():
        if key not in headers:
            rep.fail(
                f"{corpus} key '{key}'",
                f"missing (has: {sorted(headers)})",
                f"the loader indexes arr[{key!r}] — wrong or repacked archive",
            )
            return
        shape, _ = headers[key]
        if len(shape) not in ndim:
            rep.fail(
                f"{corpus} key '{key}'",
                f"shape {shape} has ndim {len(shape)}, expected {sorted(ndim)}",
                "wrong archive variant (e.g. the *_complex or tfrecord repack)",
            )
            return
    rows = headers[next(iter(want))][0][0]
    if rows != expected_rows:
        rep.warn(
            f"{corpus} row count", f"{rows:,} rows (full corpus has "
            f"{expected_rows:,})",
            "fine if this is a deliberate subset; factor grids assume the "
            "full cartesian product for the disentanglement metrics",
        )
    else:
        rep.ok(f"{corpus} archive", f"{rows:,} rows, keys/shapes match the loader")


def _check_dataset(rep: _Report, name: str, data_root: Optional[str]) -> None:
    print(f"[dataset: {name}]")
    if name.startswith("synthetic"):
        rep.ok("synthetic dataset", "procedural, no files needed")
        return
    root = data_root or "."
    if name.startswith("dsprites"):
        _check_npz(rep, os.path.join(root, _DSPRITES_FILE),
                   {"imgs": {3}, "latents_values": {2}}, 737280, "dSprites")
    elif name.startswith("mpi3d"):
        _check_npz(rep, os.path.join(root, _MPI3D_FILE),
                   {"images": {4}}, 1036800, "MPI3D")
    elif name.startswith("ukiyo_e"):
        _check_ukiyoe(rep, root)
    else:
        rep.fail("dataset name", f"unknown dataset '{name}'",
                 "one of: ukiyo_e{64,128,256}, dsprites[_small], "
                 "mpi3d[_small], synthetic*")


def _check_ukiyoe(rep: _Report, root: str) -> None:
    from intro_tc_vae_tpu_torch.data.datasets import UkiyoE

    csv_path = os.path.join(root, _UKIYOE_CSV)
    img_dir = os.path.join(root, _UKIYOE_DIR)
    if not os.path.exists(csv_path):
        rep.fail("Ukiyo-E metadata", f"{csv_path} not found",
                 f"place {_UKIYOE_CSV} in data_root (ARC face-crop release)")
        return
    try:
        labels = UkiyoE.load_labels(root)  # columns as lists, no pandas
    except Exception as e:
        rep.fail("Ukiyo-E metadata", f"CSV unparseable: {e!r}",
                 f"the CSV must have >= {len(UkiyoE.COLUMN_NAMES)} columns "
                 "(renamed positionally); re-download the metadata file")
        return
    rep.ok("Ukiyo-E metadata", f"{len(labels['filename']):,} rows, columns parse")
    if not os.path.isdir(img_dir):
        rep.fail("Ukiyo-E images", f"{img_dir}/ not found",
                 f"extract the face-crop images into {_UKIYOE_DIR}/")
        return
    name_col = "singleface_filename" if "singleface_filename" in labels else "filename"
    names = [str(n) for n in labels[name_col]]
    on_disk = sum(os.path.exists(os.path.join(img_dir, n)) for n in names)
    if on_disk == 0:
        rep.fail(
            "Ukiyo-E images",
            f"0 of {len(names):,} CSV '{name_col}' entries exist in {img_dir}",
            "image filenames must match the CSV column; check the extraction "
            "directory layout (files directly inside, no subfolders)",
        )
    elif on_disk < len(names):
        rep.warn(
            "Ukiyo-E images",
            f"{on_disk:,}/{len(names):,} CSV entries found on disk "
            "(missing files are skipped, matching the reference loader)",
            "",
        )
    else:
        rep.ok("Ukiyo-E images", f"all {on_disk:,} CSV entries on disk")
    # decode one image as the loader does
    for n in names:
        p = os.path.join(img_dir, n)
        if os.path.exists(p):
            try:
                from PIL import Image

                with Image.open(p) as im:
                    im.convert("RGB").resize((256, 256), Image.BICUBIC)
                rep.ok("Ukiyo-E decode probe", f"{n} decodes + resizes")
            except Exception as e:
                rep.fail("Ukiyo-E decode probe", f"{n}: {e!r}",
                         "corrupt image or unsupported format; re-extract")
            break


# the JAX doctor compares the tensors its converter makes parameters of:
# conv weights and BatchNorm scales and biases (running statistics, and
# num_batches_tracked, are not compared)
_PARAM_SUFFIXES = (".conv.weight", ".bn.weight", ".bn.bias")


def _check_inception(rep: _Report, weights_path: Optional[str], need_fid: bool) -> None:
    print("[inception weights (FID / encoder-FID)]")
    from intro_tc_vae_tpu_torch.models.inception import (
        WEIGHTS_ENV,
        InceptionV3Features,
        find_weights,
    )

    path = find_weights(weights_path)
    if path is None:
        (rep.fail if need_fid else rep.warn)(
            "weights file",
            "no inception weights found (FID scores unavailable)",
            f"set ${WEIGHTS_ENV} or pass --inception-weights; accepts the "
            "pytorch-fid pt_inception-2015-12-05 .pth or a torchvision "
            "inception_v3 state_dict",
        )
        return
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        got = {k: tuple(v.shape) for k, v in sd.items()
               if not k.startswith(("fc.", "AuxLogits.")) and k.endswith(_PARAM_SUFFIXES)}
    except Exception as e:
        rep.fail("weights file", f"{path}: torch load/convert failed: {e!r}",
                 "the file must be a torch state_dict (.pth); re-download")
        return
    # the same names and shapes as the model's parameters, which is what
    # load_inception_weights fills: a pass here means FID will run
    want = {k: tuple(p.shape) for k, p in InceptionV3Features().named_parameters()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad_shapes = [f"{k}: got {got[k]}, want {want[k]}"
                  for k in want if k in got and got[k] != want[k]]
    if missing or extra or bad_shapes:
        detail = "; ".join(
            ([f"{len(missing)} missing params (e.g. {missing[0]})"] if missing else [])
            + ([f"{len(extra)} unexpected params (e.g. {extra[0]})"] if extra else [])
            + bad_shapes[:3]
        )
        rep.fail("weights structure", detail,
                 "not an inception_v3 checkpoint of the expected variant; use "
                 "pt_inception-2015-12-05.pth (pytorch-fid) or torchvision's "
                 "inception_v3 weights")
    else:
        rep.ok("weights structure",
               f"{path}: all {len(want)} param tensors present, shapes match")


def activation_estimate(config) -> Tuple[int, int]:
    """(estimated bytes, image size): the JAX doctor's coarse footprint of
    the intro step's activations. Per pass, each conv stack level's output
    and its BatchNorm intermediate (spatial halving a level), 7 live
    passes (2 under ``remat: "pass"``), twice for the gradients. It leaves
    out weights, optimizer state and the allocator's slack."""
    sizes = {"ukiyo_e256": 256, "ukiyo_e128": 128, "synthetic256": 256,
             "synthetic128": 128}
    img = sizes.get(config.dataset, 64)
    chans = {64: (64, 128, 256, 512), 128: (64, 128, 256, 512, 512),
             256: (64, 128, 256, 512, 512, 512)}[img]
    bpe = 2 if config.precision == "bf16" else 4
    per_pass = 0
    h = img
    for c in chans:
        per_pass += h * h * c * 2  # conv out + BN intermediate
        h //= 2
    passes = 2 if config.remat == "pass" else 7
    return config.batch_size * per_pass * bpe * passes * 2, img  # x2 grads


def _check_device(rep: _Report, config, device: Optional[torch.device]) -> None:
    print("[device memory vs config]")
    if device is None:
        if not torch.cuda.is_available():
            rep.fail("device", "torch.cuda.is_available() is false: no CUDA device",
                     "run on a host with an NVIDIA GPU and PyTorch built for CUDA "
                     "(check nvidia-smi and torch.version.cuda)")
            return
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        rep.skip("memory estimate", f"{device.type}: no memory_stats")
        return
    try:
        free, total = torch.cuda.mem_get_info(device)
        kind = torch.cuda.get_device_name(device)
    except Exception as e:
        rep.fail("device", f"{device}: {e!r}",
                 "check that nvidia-smi lists the card, and CUDA_VISIBLE_DEVICES")
        return
    est, img = activation_estimate(config)
    frac = est / free
    gb = est / 2**30
    have = f"{free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB"
    if frac > 1.0:
        rep.fail(
            "activation memory",
            f"~{gb:.1f} GiB estimated vs {have} on {kind} (batch "
            f"{config.batch_size}, {img}px, {config.precision})",
            'set "remat": "pass" (intro solvers) or "block", lower '
            "batch_size, or use precision='bf16'",
        )
    elif frac > 0.7:
        rep.warn(
            "activation memory",
            f"~{gb:.1f} GiB estimated vs {have} on {kind} — tight",
            'consider "remat": "pass" or bf16 if the run OOMs',
        )
    else:
        rep.ok("activation memory", f"~{gb:.1f} GiB estimated vs {have} on {kind}")


def _check_dirs(rep: _Report, config) -> None:
    print("[output dirs]")
    for label, d in (("checkpoint_dir", config.checkpoint_dir),
                     ("log_dir", config.log_dir)):
        if not d:
            rep.skip(label, "unset, defaults apply")
            continue
        try:
            os.makedirs(d, exist_ok=True)
            probe = os.path.join(d, ".itcvae_doctor_probe")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
            rep.ok(label, f"{d} writable")
        except OSError as e:
            rep.fail(label, f"{d} not writable: {e!r}",
                     "create the directory or point the config elsewhere")


def main(argv=None, device: Optional[torch.device] = None) -> int:
    """Run every check and print the report; returns the exit code."""
    ap = argparse.ArgumentParser(
        description="preflight a training config: corpus layout, inception "
        "weights, device memory, output dirs")
    ap.add_argument("-f", "--config", type=str, default=None,
                    help="Path to the JSON config file (as the train CLI's)")
    ap.add_argument("-u", "--update", type=json.loads, default="{}",
                    help="Inline JSON dict overriding config values")
    ap.add_argument("--inception-weights", default=None,
                    help="explicit path to inception .pth (else env/default)")
    ap.add_argument("--fid", action="store_true",
                    help="treat missing inception weights as FAIL, not WARN")
    args = ap.parse_args(argv)

    rep = _Report()
    print("[config]")
    try:
        from intro_tc_vae_tpu_torch.config import load_config

        config = load_config(args.config, update_dict=args.update)
        rep.ok("config", f"solver={config.solver} dataset={config.dataset} "
               f"batch={config.batch_size}")
    except (ValueError, FileNotFoundError) as e:
        rep.fail("config", str(e), "fix the config file / -u overrides")
        print("\nresult: FAIL (config unusable, further checks skipped)")
        return 1

    _check_dataset(rep, config.dataset, config.data_root)
    _check_inception(rep, args.inception_weights, args.fid)
    _check_device(rep, config, device)
    _check_dirs(rep, config)

    print(f"\nresult: {'FAIL' if rep.failed else 'PASS'}")
    return 1 if rep.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
