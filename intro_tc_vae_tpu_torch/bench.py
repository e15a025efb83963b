"""Benchmark of the port: images/sec/chip on the flagship intro_tc recipe.

Counterpart of ``bench.py`` (the JAX package's), with its functions, flags
and JSON lines:

    python -m intro_tc_vae_tpu_torch.bench                      # headline
    python -m intro_tc_vae_tpu_torch.bench --batch 64 [--graph 0] [--tc-impl pallas]
    python -m intro_tc_vae_tpu_torch.bench --infer [--pack 4]

* ``main``: the full two-phase train step of the flagship (64x64x3,
  z_dim 128, conv channels 64-128-256-512, batch 64, Adam 2e-4, the
  flagship's betas) on synthetic data resident on the card, bf16 convs on
  the card and fp32 on the CPU. The timed call is ``solver.train_step``
  without a writer (``--tb``: with a live writer and ``test_iter`` 10**9,
  as the JAX bench times ``train_step``): on the card each step is one
  replay of the solver's captured graph (``solvers/graph.py::
  GraphedStep``, the counterpart of the jitted ``_step_fn``; ``--scan K``
  is K replays a call), eager with ``--graph 0``. Before the timed window
  it takes ``WARMUP`` calls plus the graph's own warm-up steps and its
  capture. ``iters`` calls are timed on the host clock between two
  ``torch.cuda.synchronize()`` calls, and the same window with CUDA events
  (printed on the line before the JSON line). The metric ring is drained
  two calls behind, as the train loop drains it, and a non-finite loss of
  any step raises (``check_finite``). Prints ``{"metric":
  "images_per_sec_per_chip", "value", "unit", "card"}``.
* ``infer``: the serving path, eval mode (running-average BatchNorm) at
  batch 256 of a ``vae`` solver: ``decode`` (prior z -> image), ``encode``
  (image -> mu) and ``decode_u8`` (decode + ``unit_f32_to_u8``, the bulk
  export). Each surface is a ``GraphedEval`` on the card (eager with
  ``--graph 0``): one untimed call, the capture and one untimed replay,
  then ``iters`` replays timed between synchronizes.
* ``headline``: the flagship at batch 64 paired and batch 128 unpaired,
  escalating to the full {paired, unpaired} x {64, 128, 256} sweep when
  the two lie within 2 %, else one rotating arm of the rest (its index in
  ``ARM_FILE``); the winner twice more, the median reported.

Differences from the JAX bench: no ``vs_baseline`` (it was against a TPU
target); the JSON lines carry the card's name and power limit (``card``);
an arm that raises makes ``headline`` raise instead of scoring 0.0; the
rotation's file is ``.bench_arm_torch``; the inference passes are timed
as replays on one stream, which orders them, so there is no chained
dispatch; ``--graph`` and ``--device`` are the port's. Runs on the card
unless ``--device cpu``, where ``--graph 1`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

BATCH = 64
INFER_BATCH = 256
IMAGE_SIZE = 64
ZDIM = 128
# conv channels by image size: the JAX bench's table, and two small rows
# for runs of the analysis tools on the CPU
CHANNELS = {64: (64, 128, 256, 512), 128: (64, 128, 256, 512, 512),
            256: (64, 128, 256, 512, 512, 512), 32: (16, 32), 16: (8, 16)}
SIZES = (4, 5, 8, 8)  # the synthetic set's factors: 1,280 images
LR = 2e-4
BETAS = dict(beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, gamma_r=1e-8)
WARMUP = 3
ITERS = 30
# the headline's rotating sweep arm, at the root of the checkout
ARM_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".bench_arm_torch")


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the
    device's name off a card)."""
    if device.type != "cuda":
        return str(device)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is None or smi.returncode != 0 or not smi.stdout.strip():
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return smi.stdout.strip().splitlines()[0]


def _device(device: str, graph) -> tuple:
    """(torch.device, graphed or not): graphed on the card unless ``graph``
    is False; a graph off the card raises, as does a missing card."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    graph = cuda if graph is None else bool(graph)
    if graph and not cuda:
        raise ValueError("--graph 1 needs the card (a CUDA graph)")
    return dev, graph


def build_solver(solver_name: str, batch: int, image_size: int, device, arch: str = "conv",
                 zdim=None, channels=None, dtype=None, pack: int = 0, tile: int = 0,
                 conv_impl: str = "xla", remat=False, **solver_kwargs) -> tuple:
    """(solver, state, x): the JAX bench's recipe on ``device``, the one
    set-up of this bench, ``analysis/profile_step.py`` and
    ``analysis/ceiling.py``. The conv channels of ``CHANNELS`` by image
    size (or ``channels``), z of ``ZDIM`` (or ``zdim``), bf16 convs on the
    card and fp32 on the CPU (or ``dtype``), ``Synthetic(sizes=SIZES)``,
    Adam at ``LR`` for both networks, weights from seed 0; ``solver_kwargs``
    go to ``make_solver`` (the betas are the caller's, ``BETAS``). ``state``
    is fresh (seed 0) in train mode, ``x`` the dataset's first ``batch``
    images (cycling), NCHW on ``device``."""
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    device = torch.device(device)
    torch.manual_seed(0)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    dataset = Synthetic(image_size=image_size, cdim=3, sizes=SIZES)
    kwargs = dict(cdim=3, zdim=zdim or ZDIM, channels=tuple(channels or CHANNELS[image_size]),
                  image_size=image_size, compute_dtype=dtype, tile_rows=tile,
                  conv_impl=conv_impl, remat=remat in (True, "block"))
    solver = make_solver(
        solver_name, dataset=dataset,
        encoder=Encoder(arch=arch, **kwargs).to(device),
        decoder=Decoder(arch=arch, pack_predict=pack, **kwargs).to(device),
        batch_size=batch,
        optimizer_e=make_optimizer("adam", LR),
        optimizer_d=make_optimizer("adam", LR),
        **solver_kwargs)
    state = solver.init_state(0)
    state.model.train()
    x = dataset.get_batch(np.arange(batch) % len(dataset)).transpose(0, 3, 1, 2)
    return solver, state, torch.from_numpy(np.ascontiguousarray(x)).to(device)


def main(batch=BATCH, image_size=IMAGE_SIZE, arch="conv", solver_name="intro_tc",
         tc_impl="xla", iters=ITERS, scan=1, fuse=True, emit=True, tb=False,
         pack=0, tile=0, remat=False, conv_impl="xla", graph=None, device="cuda") -> dict:
    """Train-step throughput. Returns ``img_s``, ``device_ms_per_step``
    (the timed window on the card's clock, CUDA events, per step: idle
    time between kernels included; None off the card), ``steps`` (every
    train step taken, warm-up included), ``last_loss_enc`` and ``card``."""
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH

    dev, graph = _device(device, graph)
    cuda = dev.type == "cuda"
    writer = None
    if tb:  # the full train_step with live TensorBoard writes
        from intro_tc_vae_tpu_torch.utils.writer import make_writer

        writer = make_writer(log_dir=tempfile.mkdtemp(prefix="itcvae-tbbench-"))
    solver, state, x = build_solver(
        solver_name, batch, image_size, dev, arch=arch, pack=pack, tile=tile,
        conv_impl=conv_impl, remat=remat, **BETAS, tc_impl=tc_impl, scan_steps=scan,
        fuse_passes=fuse, writer=writer,
        test_iter=10**9,  # scalar writes only, and the heavy metrics at step 0
        remat_passes=remat == "pass", graph=graph)
    if scan > 1:
        x = x.expand(scan, *x.shape)

    def check(drained):
        for metrics, _ in drained:
            solver.check_finite(metrics)

    def call():
        _, metrics = solver.train_step(state, x)
        if len(solver.metric_ring) >= RING_DEPTH + 2:
            check(solver.drain_metrics(keep_tail=2))
        return metrics

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    warm = WARMUP + (-(-(solver.graphed.warmup + 1) // scan) if graph else 0)
    for _ in range(warm):
        call()
    if graph and solver.graphed.captures != 1:
        raise RuntimeError(f"{solver.graphed.captures} captures after the warm-up, expected 1")
    sync()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = call()
    if cuda:
        end.record()
    sync()
    dt = time.perf_counter() - t0
    device_ms = start.elapsed_time(end) / (iters * scan) if cuda else None
    last = float(metrics["loss_enc"].reshape(-1)[-1])
    try:
        check(solver.flush_writes())
    finally:
        if writer is not None:
            writer.close()
    img_s = batch * scan * iters / dt
    name = card(dev)
    out = {"img_s": img_s, "device_ms_per_step": device_ms, "steps": (warm + iters) * scan,
           "last_loss_enc": last, "card": name}
    if emit:
        steps = f"{iters} calls of {scan} step{'s' if scan > 1 else ''}, batch {batch}"
        device_part = (f"; the card's clock {device_ms:.3f} ms/step (CUDA events around "
                       "the same window)" if cuda else "")
        print(f"bench: {solver_name} {'graphed' if graph else 'eager'}, {steps}: host "
              f"{dt * 1e3 / (iters * scan):.3f} ms/step{device_part} on {name}")
        print(json.dumps({"metric": "images_per_sec_per_chip", "value": round(img_s, 1),
                          "unit": "img/s", "card": name}))
    return out


def surfaces(state) -> dict:
    """The serving path's eval-mode passes on ``state``'s modules:
    ``decode`` (z -> image), ``encode`` (image -> mu) and ``decode_u8``
    (the decoded image as uint8, ``unit_f32_to_u8``)."""
    from intro_tc_vae_tpu_torch.solvers.base import decode, encode, unit_f32_to_u8

    enc, dec = state.model.encoder, state.model.decoder
    return {"decode": lambda z: decode(dec, z, train=False),
            "encode": lambda x: encode(enc, x, train=False)[0],
            "decode_u8": lambda z: unit_f32_to_u8(decode(dec, z, train=False))}


def build_infer(batch: int, image_size: int, arch: str, pack: int, device) -> tuple:
    """(solver, state, inputs by surface) of the JAX bench's serving
    set-up: a ``vae`` solver and its fresh state, the first ``batch``
    images and a prior draw (seed 1) of ``batch`` latents, on ``device``."""
    solver, state, x = build_solver("vae", batch, image_size, device, arch=arch, pack=pack,
                                    beta_kl=BETAS["beta_kl"], beta_rec=BETAS["beta_rec"])
    z = torch.randn((batch, ZDIM), generator=torch.Generator().manual_seed(1)).to(device)
    return solver, state, {"decode": z, "encode": x, "decode_u8": z}


def infer(batch=INFER_BATCH, image_size=IMAGE_SIZE, arch="conv", iters=ITERS, pack=0,
          graph=None, device="cuda") -> dict:
    """Serving-path throughput. Returns ``rows`` (img/s by surface) and
    what was timed, for a caller to hold it to the eager passes:
    ``state``, ``inputs`` by surface and ``runs``, each surface's
    ``GraphedEval`` (its eager pass is its ``fn``), or the eager pass
    itself with ``graph`` False."""
    from intro_tc_vae_tpu_torch.solvers.graph import GraphedEval

    dev, graph = _device(device, graph)
    _, state, inputs = build_infer(batch, image_size, arch, pack, dev)
    rows, runs = {}, {}
    for name, fn in surfaces(state).items():
        run = runs[name] = GraphedEval(fn, (state.model,)) if graph else fn
        inp = inputs[name]
        run(inp)  # eager
        run(inp)  # graphed: the capture and one replay
        if graph and run.captures != 1:
            raise RuntimeError(f"{name}: {run.captures} captures, expected 1")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(inp)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rows[name] = round(batch * iters / (time.perf_counter() - t0), 1)
    print(json.dumps({"metric": "inference_images_per_sec_per_chip", "unit": "img/s",
                      "batch": batch, "image_size": image_size, **rows, "card": card(dev)}))
    return {"rows": rows, "state": state, "inputs": inputs, "runs": runs}


def headline(full_sweep: bool = False) -> dict:
    """The flagship at batch 64 paired and 128 unpaired (the JAX bench's
    fast path) or the full sweep; escalation, rotation and repeats as in
    the JAX bench. Any arm that raises makes the headline raise."""
    all_configs = [(b, f) for f in (True, False) for b in (64, 128, 256)]
    configs = all_configs if full_sweep else [(64, True), (128, False)]
    rows: dict[str, float] = {}
    name = None

    def key(batch, fuse):
        return f"b{batch}_{'paired' if fuse else 'unpaired'}"

    def measure(batch, fuse):
        nonlocal name
        out = main(batch=batch, fuse=fuse, emit=False)
        name = out["card"]
        return round(out["img_s"], 1)

    for batch, fuse in configs:
        rows[key(batch, fuse)] = measure(batch, fuse)

    if not full_sweep:
        vals = sorted(rows.values(), reverse=True)
        rest = [c for c in all_configs if c not in configs]
        if (vals[0] - vals[1]) / vals[0] < 0.02:
            print("fast-path configs within 2%: crossover in play, "
                  "escalating to the full sweep", flush=True)
            for batch, fuse in rest:
                rows[key(batch, fuse)] = measure(batch, fuse)
        else:
            try:
                with open(ARM_FILE) as f:
                    idx = int(f.read().strip())
            except (OSError, ValueError):
                idx = 0
            batch, fuse = rest[idx % len(rest)]
            try:
                with open(ARM_FILE, "w") as f:
                    f.write(str(idx + 1))
            except OSError:
                pass  # a read-only checkout: the rotation restarts at arm 0
            print(f"rotating sweep arm {idx % len(rest)}: {key(batch, fuse)}", flush=True)
            rows[key(batch, fuse)] = measure(batch, fuse)

    best_key = max(rows, key=rows.get)  # type: ignore[arg-type]
    best_batch = int(best_key.split("_")[0][1:])
    best_fuse = best_key.endswith("_paired")
    repeats = [rows[best_key]] + [measure(best_batch, best_fuse) for _ in range(2)]
    value = float(np.median(repeats))
    line = {"metric": "images_per_sec_per_chip", "value": round(value, 1), "unit": "img/s",
            "batch": best_batch, "fuse_passes": best_fuse, "repeats": repeats,
            "batch64_flagship": rows.get("b64_paired", 0.0), **rows, "card": name}
    print(json.dumps(line))
    return line


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = headline mode (batch 64 + 128, best wins)")
    ap.add_argument("--image-size", type=int, default=IMAGE_SIZE)
    ap.add_argument("--arch", default="conv")
    ap.add_argument("--solver", default="intro_tc")
    ap.add_argument("--tc-impl", default="xla")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--scan", type=int, default=1,
                    help="K steps a train_step call (K graph replays)")
    ap.add_argument("--pack", type=int, default=0,
                    help="decoder pack_predict block size (0 = plain conv)")
    ap.add_argument("--conv-impl", default="xla",
                    help="3x3 conv impl: xla | pallas (the CUDA kernels) | hybrid")
    ap.add_argument("--tile", type=int, default=0,
                    help="strip-tile convs at >=2x this input height "
                         "(models/blocks.py::StripTiledConv; 0 = off)")
    ap.add_argument("--remat", nargs="?", const="block", default=False,
                    choices=["block", "pass"],
                    help="activation remat: 'block' = per conv block; "
                         "'pass' = whole encode/decode passes of the intro step")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable paired-pass fusion (solvers/intro.py)")
    ap.add_argument("--tb", action="store_true",
                    help="bench the full train_step with a live TensorBoard writer")
    ap.add_argument("--sweep", action="store_true",
                    help="headline mode with the full {paired,unpaired} x "
                         "{64,128,256} sweep instead of the 2-config fast path")
    ap.add_argument("--infer", action="store_true",
                    help="serving-path bench: eval-mode decode/encode throughput "
                         "(uses --batch, default 256)")
    ap.add_argument("--graph", type=int, choices=(0, 1), default=None,
                    help="1: captured CUDA graphs (the default on the card); 0: eager")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    graph = None if a.graph is None else bool(a.graph)
    if a.infer:
        infer(batch=a.batch or INFER_BATCH, image_size=a.image_size, arch=a.arch,
              iters=a.iters, pack=a.pack, graph=graph, device=a.device)
    elif a.batch == 0:
        headline(full_sweep=a.sweep)
    else:
        main(a.batch, a.image_size, a.arch, a.solver, a.tc_impl, a.iters, a.scan,
             fuse=not a.no_fuse, tb=a.tb, pack=a.pack, tile=a.tile, remat=a.remat,
             conv_impl=a.conv_impl, graph=graph, device=a.device)


if __name__ == "__main__":
    cli()
