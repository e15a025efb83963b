"""Driver of the ``sample`` mix: one client in a closed loop, each request
``batch`` prior latents in, as many uint8 images out.

Set-up (``build``): the weights are made from the seed, and the decoder's
running statistics are calibrated from them (``reference/model.py::
calibrated_stats``, one train-mode pass of the reference over prior
latents), so that a decoder made from a seed gives images over the whole
range, as a trained one does. The program's ``Decoder`` is built from the
configuration (as ``train.setup`` builds it), given those weights and
statistics, and put in eval mode; its serving pass, ``decode`` then
``unit_f32_to_u8``, runs as a ``GraphedEval`` on the card. The latents of
``latent_sets`` requests are drawn on the host into pinned memory;
request i sends set i mod ``latent_sets``. The first requests warm up
the graph (its eager call, its capture).

A request (``request``): copy its latents in, replay the pass and wait
for it, copy the images to the host as uint8 NHWC (as ``sample.py::
to_host_u8`` returns them), and end at a synchronize. Its latency runs
from the copy in to the images on the host. A seeded reservoir keeps
``checked_requests`` of the window's requests, which the reference
decodes again once the window has closed (``check``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from perfbench.core import data
from perfbench.core.common import arch_of, no_tf32, sync
from perfbench.core.spans import Spans
from perfbench.reference import model as ref

CALIBRATION_LATENTS = 64


@dataclasses.dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    arch: ref.Arch
    batch: int
    seeds: dict
    bank: torch.Tensor
    stats: dict
    decoder: object = None
    serve: object = None
    spans: Spans = dataclasses.field(default_factory=Spans)
    kept: list = dataclasses.field(default_factory=list)  # [(request, uint8 NHWC images)]
    seen: int = 0       # requests offered to the reservoir
    requests: int = 0
    reservoir: Optional[np.random.RandomState] = None


def build(cell, seed: int, device) -> Session:
    """Everything before the window; see the module docstring."""
    from intro_tc_vae_tpu_torch.models import Decoder, resolve_conv_impl, resolve_tile_rows
    from intro_tc_vae_tpu_torch.solvers.base import decode, unit_f32_to_u8
    from intro_tc_vae_tpu_torch.solvers.graph import GraphedEval

    device = torch.device(device)
    traffic, cfg = cell.traffic, cell.config["config"]
    seeds = data.sub_seeds(seed)
    arch = arch_of(cell)
    spans = Spans()
    weights = ref.make_weights(arch, seeds["weights"], device)
    gen = torch.Generator(device=device).manual_seed(seeds["noise"])
    z_cal = torch.randn((CALIBRATION_LATENTS, arch.zdim), generator=gen, device=device)
    with no_tf32():
        stats = ref.calibrated_stats(weights, arch, z_cal)
    del z_cal
    bank = torch.from_numpy(data.latent_bank(int(traffic["latent_sets"]), int(traffic["batch"]),
                                             arch.zdim, seeds["latents"]))
    if device.type == "cuda":
        bank = bank.pin_memory()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    decoder = Decoder(arch=cfg["arch"], cdim=arch.cdim, zdim=arch.zdim,
                      channels=arch.channels, image_size=arch.image_size,
                      compute_dtype=torch.bfloat16 if cfg["precision"] == "bf16"
                      else torch.float32,
                      conv_impl=resolve_conv_impl(cfg.get("conv_impl", "auto")),
                      tile_rows=resolve_tile_rows(cfg.get("tile_rows", -1), arch.image_size),
                      pack_predict=max(0, cfg.get("pack_predict", -1))).to(device)
    dec_weights = {k[len("decoder."):]: v for k, v in weights.items() if k.startswith("decoder.")}
    missing = set(dict(decoder.named_parameters())) ^ set(dec_weights)
    if missing:
        raise RuntimeError(f"the program's decoder leaves differ: {sorted(missing)[:6]}")
    state = {**dec_weights, **{k[len("decoder."):]: v for k, v in stats.items()}}
    decoder.load_state_dict(state, strict=True)
    decoder.eval()

    def serve_pass(z):
        return unit_f32_to_u8(decode(decoder, z, train=False))

    serve = GraphedEval(serve_pass, (decoder,)) if device.type == "cuda" else serve_pass
    s = Session(cell=cell, seed=seed, device=device, arch=arch, batch=int(traffic["batch"]),
                seeds=seeds, bank=bank, stats=stats, decoder=decoder, serve=serve,
                reservoir=np.random.RandomState(seeds["sample"]), spans=spans)
    with spans("setup_warmup"):
        for _ in range(int(traffic["warmup_requests"])):
            request(s, keep=False)
        sync(device)
    return s


def request(s: Session, keep: bool = True) -> float:
    """One request; returns its latency in seconds."""
    spans, dev = s.spans, s.device
    i = s.requests
    t0 = time.perf_counter()
    with spans("copy_in"):
        z = s.bank[i % len(s.bank)].to(dev, non_blocking=True)
    with spans("decode"):
        out = s.serve(z)
        sync(dev)
    with spans("copy_out"):
        images = out.permute(0, 2, 3, 1).cpu().numpy()
        sync(dev)
    latency = time.perf_counter() - t0
    if keep:
        _reservoir(s, i, images)
    s.requests += 1
    return latency


def _reservoir(s: Session, i: int, images: np.ndarray) -> None:
    """Keep request ``i`` as a uniform sample of ``checked_requests`` of the
    requests so far keeps it (Vitter's algorithm R, seeded)."""
    k = int(s.cell.traffic["checked_requests"])
    s.seen += 1
    if len(s.kept) < k:
        s.kept.append((i, images))
        return
    j = s.reservoir.randint(0, s.seen)
    if j < k:
        s.kept[j] = (i, images)


@dataclasses.dataclass
class Window:
    seconds: float
    requests: int
    images: int
    latencies_s: list
    lo: float
    hi: float
    trace: object = None
    traced: tuple = ()  # (t_on, t_off) of the traced stretch on the host clock
    trace_units: int = 0  # requests the traced stretch covered

    @property
    def units(self) -> int:
        return self.requests


def window(s: Session, seconds: float, trace: bool) -> Window:
    from perfbench.core.profiled import Stretch

    stretch = Stretch(s.spans, s.device) if trace else None
    latencies = []
    t0 = time.perf_counter()
    done = 0
    while True:
        if stretch is not None:
            stretch.before(done, time.perf_counter() - t0, seconds)
        latencies.append(request(s))
        done += 1
        if stretch is not None:
            stretch.after(done)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if stretch is not None:
        stretch.close(done)
    return Window(seconds=t1 - t0, requests=done, images=done * s.batch,
                  latencies_s=latencies, lo=t0, hi=t1,
                  trace=stretch.trace if stretch is not None else None,
                  traced=(stretch.t_on, stretch.t_off) if stretch and stretch.t_on else (),
                  trace_units=stretch.units if stretch is not None else 0)


def free(s: Session) -> None:
    s.serve = None
    s.decoder = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_images(s: Session, weights: dict, request: int, quantizer=None) -> np.ndarray:
    """The reference's uint8 NHWC images for ``request``'s latents."""
    z = s.bank[request % len(s.bank)].to(s.device)
    with no_tf32(), torch.no_grad():
        img = ref.decoder(weights, s.arch, z, ref.QUANTIZERS[quantizer], stats=s.stats)
    return ref.unit_to_u8(img).permute(0, 2, 3, 1).cpu().numpy()


def compare(pairs) -> dict:
    """Over (program images, reference images) pairs of uint8 NHWC:
    ``image_gap``, the worst image's mean absolute difference in levels,
    and ``pixel_gap``, the largest difference of any one value."""
    image_gap, pixel_gap = 0.0, 0
    for prog, refr in pairs:
        if prog.shape != refr.shape:
            return {"image_gap": float("inf"), "pixel_gap": 255}
        d = np.abs(prog.astype(np.int16) - refr.astype(np.int16))
        image_gap = max(image_gap, float(d.reshape(len(d), -1).mean(axis=1).max()))
        pixel_gap = max(pixel_gap, int(d.max()))
    return {"image_gap": image_gap, "pixel_gap": pixel_gap}


def check(s: Session, stand_in: Optional[str] = None) -> dict:
    """The comparison's numbers over the kept requests (``stand_in``
    "fp8": the reference in float8 in the program's place)."""
    weights = ref.make_weights(s.arch, s.seeds["weights"], s.device)
    pairs = []
    for i, images in sorted(s.kept, key=lambda kv: kv[0]):
        refr = reference_images(s, weights, i)
        prog = images if stand_in is None else reference_images(s, weights, i, stand_in)
        pairs.append((prog, refr))
    out = compare(pairs)
    out["requests_checked"] = len(pairs)
    return out


def end_to_end(win: Window) -> dict:
    """``sample_img_s``: every image delivered to the host in the window
    over the window; ``sample_ms_p95``: the 95th percentile of all the
    window's request latencies."""
    from perfbench.core.stats import percentile, rate

    return {"sample_img_s": rate(win.images, win.seconds),
            "sample_ms_p95": 1e3 * percentile(win.latencies_s, 95)}
