"""Speed-of-light calibration per recipe: operations of one train step,
the card's sustained bf16 matrix rate, and the images a second those allow.

Counterpart of ``analysis/ceiling.py`` (the JAX package's), with its
``CONFIGS`` and ``--measure``. For each (solver, image size, batch):

* **Operations of one step.** One eager step of the recipe (conv arch,
  channels by image size, z 128, Adam 2e-4, the flagship's betas) on a
  ``Synthetic`` batch, under ``torch.utils.flop_counter.FlopCounterMode``,
  with ``tc_impl`` and ``conv_impl`` ``"xla"``: the stock arm, so that the
  count is of the work and not of who does it (the hand kernels' calls are
  invisible to the counter). The counter counts the conv and matrix
  products, forward and backward (a backward counts the input gradient
  and the weight gradient each where autograd computes it). To that the
  TC op's operations are added, per call of the KL term and per backward
  of it, by the formula the TC kernels' bounds use (``TC_OPS``, per (row,
  bank row, latent) and per (row, bank row)).
  Against XLA's ``cost_analysis()`` flops, which the JAX script reads, the
  count leaves out the elementwise and normalization work: BatchNorm, the
  activations, the losses' and the reparameterization's arithmetic, the
  casts, the optimizer's update.
* **The sustained rate.** 20 chained 8192^3 bf16 matrix products
  (``torch.matmul``) timed with CUDA events, as the JAX script measured
  its chip, printed beside the H100's nominal 989 TFLOP/s of dense bf16.
* ``gflop_per_image`` and ``ceiling_img_s`` (the sustained rate over the
  operations of an image); ``--measure`` adds ``measured_img_s`` (a short
  run of ``train.train_soft_intro_vae`` at that size on synthetic data,
  graphed on the card: ``train.images_per_second``) and
  ``pct_of_ceiling``.

    python -m intro_tc_vae_tpu_torch.analysis.ceiling [--measure] [--only intro_tc:64:64]

Each config prints one JSON line, as in JAX; the last line is one JSON
object with every row and the rate. Counts and runs on the card unless
``--device cpu`` (float32 there, as the JAX script off the TPU).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile

NOMINAL_TFLOPS = 989.0  # H100 SXM, dense bf16 (the data sheet)
MEASURE_STEPS = 20      # --measure: one epoch of 20 steps, the first 4 left out
MATMUL_SIZE, MATMUL_CHAIN = 8192, 20  # the sustained rate's chain of [size, size] products
Z_DIM = 128

CONFIGS = [
    ("intro_tc", 64, 64),    # flagship
    ("intro_tc", 128, 64),   # intro_tc_128_dp8's shapes
    ("intro_tc", 256, 32),   # ukiyo_e256's shapes at the reference's default batch
    ("intro_tc", 256, 64),   # ukiyo_e256 at batch 64
    ("vae", 64, 64),         # the single-phase solvers
    ("tc", 64, 64),
]

CHANNELS = {64: (64, 128, 256, 512), 128: (64, 128, 256, 512, 512),
            256: (64, 128, 256, 512, 512, 512)}

# The TC kernels' operations (a copy of chip_smoke.py's TC_OPS: a fused
# multiply-add is two, a float64 exp 29): per (row, bank row, latent) and
# per (row, bank row) of the forward and of the two backward kernels.
TC_EXP_OPS, TC_DENSITY_OPS = 29, 5
TC_OPS = {
    "tc_fwd": (TC_DENSITY_OPS + 1 + TC_EXP_OPS + 2, 4 + TC_EXP_OPS),
    "tc_bwd_dz": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2 + 3, 3 + TC_EXP_OPS),
    "tc_bwd_dmu": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2, 3 + TC_EXP_OPS),
}


def tc_call_ops(b: int, zdim: int, backward: bool) -> int:
    """Operations of one TC call over a batch of ``b`` (its own bank),
    with the backward's two kernels where the call is differentiated."""
    kernels = ("tc_fwd", "tc_bwd_dz", "tc_bwd_dmu") if backward else ("tc_fwd",)
    return sum(b * b * (zdim * TC_OPS[k][0] + TC_OPS[k][1]) for k in kernels)


@contextlib.contextmanager
def tc_calls():
    """The (batch, z, differentiated) of every ``ops.total_correlation``
    call made in the block."""
    from intro_tc_vae_tpu_torch import ops

    calls, original = [], ops.total_correlation

    def counted(z, mu, logvar, *args, **kwargs):
        calls.append((z.shape[0], z.shape[1], z.requires_grad or mu.requires_grad))
        return original(z, mu, logvar, *args, **kwargs)

    ops.total_correlation = counted
    try:
        yield calls
    finally:
        ops.total_correlation = original


def build(solver_name: str, image_size: int, batch: int, device, channels=None,
          zdim: int = Z_DIM):
    """(solver, state, batch) of the recipe on ``device``, eager, the stock
    arm (``tc_impl`` and ``conv_impl`` "xla"): bf16 convs on the card,
    float32 on the CPU."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    torch.manual_seed(0)
    channels = tuple(channels or CHANNELS[image_size])
    ds = Synthetic(image_size=image_size, cdim=3, sizes=(4, 5, 8, 8))
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    kw = dict(arch="conv", cdim=3, zdim=zdim, channels=channels, image_size=image_size,
              conv_impl="xla", compute_dtype=dtype)
    solver = make_solver(
        solver_name, dataset=ds, encoder=Encoder(**kw).to(device),
        decoder=Decoder(**kw).to(device), batch_size=batch,
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, tc_impl="xla")
    state = solver.init_state(0)
    state.model.train()
    x = ds.get_batch(np.arange(batch) % len(ds)).transpose(0, 3, 1, 2)
    return solver, state, torch.from_numpy(x.copy()).to(device)


def step_flops(solver_name: str, image_size: int, batch: int, device="cuda",
               channels=None, zdim: int = Z_DIM) -> dict:
    """Operations of one train step: ``products`` (FlopCounterMode's conv
    and matrix products), ``tc`` (the TC op's, ``tc_call_ops`` per call)
    and their ``total``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    solver, state, x = build(solver_name, image_size, batch, device, channels, zdim)
    counter = FlopCounterMode(display=False)
    with tc_calls() as calls, counter:
        solver.train_step(state, x)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    products = int(counter.get_total_flops())
    tc = sum(tc_call_ops(b, z, grad) for b, z, grad in calls)
    return {"products": products, "tc": tc, "total": products + tc, "tc_calls": len(calls)}


def products_from_shapes(solver, state, x) -> int:
    """The conv and linear products of one train step on ``x`` from each
    layer call's shapes (forward hooks): its forward products, once more
    for the input gradient where the input requires one and once more for
    the weight gradient where the weight does. An independent derivation
    of ``step_flops``' ``products``, which the tests and the card's smoke
    test hold it to."""
    import torch

    total = []

    def hook(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            per = module.in_channels // module.groups * module.kernel_size[0] * module.kernel_size[1]
        else:
            per = module.in_features
        total.append(2 * out.numel() * per
                     * (1 + args[0].requires_grad + module.weight.requires_grad))

    handles = [m.register_forward_hook(hook) for m in state.model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        solver.train_step(state, x)
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def sustained_tflops(device, size: int, chain: int) -> float:
    """TFLOP/s of ``chain`` chained [size, size] matrix products (bf16 on
    the card, float32 on the CPU), the median of 5 timings (CUDA events on
    the card)."""
    import torch

    from intro_tc_vae_tpu_torch.analysis._timing import median_ms

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=g, device=dev, dtype=dtype) / size ** 0.5
    b = torch.randn((size, size), generator=g, device=dev, dtype=dtype) / size ** 0.5

    def chained():
        c = a
        for _ in range(chain):
            c = torch.matmul(c, b)
        return c

    ms = median_ms(chained, dev, reps=5, inner=1, warmup=1)
    return 2.0 * size ** 3 * chain / (ms * 1e-3) / 1e12


def measure_img_s(solver_name: str, image_size: int, batch: int, device, steps: int) -> float:
    """Host-clock img/s of a ``steps``-step epoch through
    ``train.train_soft_intro_vae`` at the recipe's size on synthetic data
    (the trainer graphs the step on the card), over the steps after the
    first ``train.WARMUP_STEPS``."""
    import torch

    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import Synthetic

    channels = list(CHANNELS[image_size])
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="itcvae-ceiling-") as tmp:
        config = load_config(update_dict=dict(
            solver=solver_name, dataset="synthetic", num_epochs=1, batch_size=batch,
            z_dim=Z_DIM, arch="conv", lr=2e-4, beta_kl=0.5, beta_rec=0.75, beta_neg=512.0,
            gamma_r=1e-8, precision="bf16" if cuda else "fp32",
            tc_impl="pallas" if cuda else "xla", conv_impl="pallas" if cuda else "xla",
            use_tensorboard=False, seed=0, log_dir=os.path.join(tmp, "tb"),
            checkpoint_dir=os.path.join(tmp, "ckpt"), test_iter=10**6,
            save_interval=10**6))

        class Cut(Synthetic):  # one epoch of `steps` batches
            def __len__(self):
                return steps * batch

        data = Cut(image_size=image_size, cdim=3, sizes=(4, 5, 8, 8))
        original = train.load_dataset
        train.load_dataset = lambda name, data_root=None: (data, image_size, channels, 3)
        try:
            state = train.train_soft_intro_vae(config, device=torch.device(device))
        finally:
            train.load_dataset = original
    return train.images_per_second(state, batch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true",
                    help="also measure throughput through the trainer per config")
    ap.add_argument("--only", action="append", default=None,
                    help="solver:image_size:batch of CONFIGS to run (repeatable; default all)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    device = torch.device(a.device)
    configs = CONFIGS
    if a.only:
        wanted = [tuple(s.split(":")) for s in a.only]
        configs = [(n, int(s), int(b)) for n, s, b in wanted]
    rate = sustained_tflops(device, MATMUL_SIZE, MATMUL_CHAIN)
    print(json.dumps({"sustained_tflops": rate, "matmul": [MATMUL_SIZE, MATMUL_CHAIN],
                      "nominal_tflops": NOMINAL_TFLOPS, "device": str(device)}), flush=True)
    rows = []
    for solver_name, image_size, batch in configs:
        count = step_flops(solver_name, image_size, batch, device, zdim=Z_DIM)
        gflop_img = count["total"] / batch / 1e9
        ceiling = rate * 1e3 / gflop_img  # img/s
        row = dict(solver=solver_name, image_size=image_size, batch=batch,
                   gflop_per_image=round(gflop_img, 3), ceiling_img_s=round(ceiling, 1),
                   ceiling_img_s_nominal=round(NOMINAL_TFLOPS * 1e3 / gflop_img, 1),
                   step_flops=count)
        if a.measure:
            measured = measure_img_s(solver_name, image_size, batch, device, MEASURE_STEPS)
            row["measured_img_s"] = round(measured, 1)
            row["pct_of_ceiling"] = round(100.0 * measured / ceiling, 2)
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"metric": "ceiling", "device": str(device),
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
           "sustained_tflops": rate, "nominal_tflops": NOMINAL_TFLOPS, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
