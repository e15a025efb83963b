#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (intro_tc_vae_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: compiles the TC kernels (intro_tc_vae_tpu_torch/csrc/
   tc_kernels.cu) and the 3x3 conv kernels (csrc/conv_kernels.cu) from the
   checkout's sources, one nvcc each, started together, and loads them.
3. Kernels vs plain, TF32 off.
   TC: tc_fwd, tc_bwd_dz and tc_bwd_dmu against the plain PyTorch version
   (evaluated in float64 on the same inputs) at B in {64, 512}, Z=128,
   N=1280, with the variance floor and the -50 clamp active; rtol 1e-4,
   atol 1e-5 on every element. Median times of each kernel and of the
   float32 plain version.
   Conv: conv3x3_fwd (forward and dx), conv3x3_dw and conv3x3_dw_reduce at
   the flagship's shapes, NCHW [128, 64, 64, 64] and [128, 64, 32, 32], in
   fp32 and bf16, against the plain version in float64 on the same
   (bf16-rounded) inputs; tolerances in ``conv_bound``. Median times at
   bf16 beside cuDNN's forward, backward-data and backward-weight.
4. Main path: ``intro_tc_vae_tpu_torch.main.cli`` trains the flagship
   recipe (configs/intro_tc_ukiyo64.json: 64x64x3, conv arch, channels
   64-512, z=128, batch 64, bf16, paired) on the synthetic dataset for one
   epoch = 20 steps in four arms: (tc_impl, conv_impl) = (pallas, xla),
   (xla, xla), (pallas, pallas), (pallas, hybrid). Every loss is finite;
   the launch counters of each phase of each step rise by exactly the
   counts derived in ``expected_intro_launches``. The rates in img/s,
   steps after the first 3.
5. In context, fp32, TF32 off. (a) One step with tc_impl 'pallas' and one
   with 'xla' from the same weights, batch and noise agree (metrics rtol
   1e-4, updated parameters atol 1e-5); as in phase 3, the 'xla' step
   evaluates the plain TC version in float64; the all-float32 'xla' step's
   distance is printed beside it. (b) One step with conv_impl 'pallas'
   and one with 'xla', same weights, batch and noise: metrics rtol 1e-4,
   updated parameters within 2 lr (Adam's first update is about
   lr sign(g)). (c) The flagship decoder's forward and backward in train
   and eval mode, conv_impl 'pallas' and 'xla' each against the float64
   decoder: output and every parameter gradient (tolerances in
   ``phase_decoder``).
6. The other paths at full width, each 20 steps through the CLI with
   conv_impl 'pallas' and then 'xla': configs/vae_synthetic.json (res
   arch, vae solver, fp32) and configs/tc_dsprites.json on the synthetic
   dataset with tc_impl 'pallas' (conv arch, tc solver, fp32). Finite
   losses, exact launch counts, img/s.

Then one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(HERE, "configs", "intro_tc_ukiyo64.json")
VAE_SYNTHETIC = os.path.join(HERE, "configs", "vae_synthetic.json")
TC_DSPRITES = os.path.join(HERE, "configs", "tc_dsprites.json")
LIBRARIES = ("tc_kernels", "conv_kernels")
SOURCE = {
    "tc_fwd": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "tc_bwd_dz": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "tc_bwd_dmu": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "conv3x3_fwd": "intro_tc_vae_tpu_torch/csrc/conv_kernels.cu",
    "conv3x3_dw": "intro_tc_vae_tpu_torch/csrc/conv_kernels.cu",
    "conv3x3_dw_reduce": "intro_tc_vae_tpu_torch/csrc/conv_kernels.cu",
}
REPLACES = {
    "tc_fwd": "intro_tc_vae_tpu/ops/tc_pallas.py:109",
    "tc_bwd_dz": "intro_tc_vae_tpu/ops/tc_pallas.py:174",
    "tc_bwd_dmu": "intro_tc_vae_tpu/ops/tc_pallas.py:202",
    "conv3x3_fwd": "intro_tc_vae_tpu/ops/conv_pallas.py:238",
    "conv3x3_dw": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
    # the TPU grid summed dW across its ordered steps inside _dwp_kernel
    "conv3x3_dw_reduce": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
}
RTOL, ATOL = 1e-4, 1e-5
Z_DIM, DATASET_SIZE, MAIN_B = 128, 1280, 64
LR = 2e-4
# the flagship's paired decoder calls: x [2B, 64, 64, 64] (res_in_64.conv1,
# .conv2) and [2B, 64, 32, 32] (res_in_32.conv2)
CONV_SHAPES = ((2 * MAIN_B, 64, 64, 64), (2 * MAIN_B, 64, 32, 32))


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convs (cuDNN runs fp32 convs in TF32
    by default) and deterministic cuDNN algorithms; restored on exit."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def median_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over `reps` of the CUDA-event time of `inner` back-to-back
    calls, per call, after a warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def tc_inputs(b: int, seed: int):
    """z, mu, logvar [b, Z] from numpy; logvar scaled x4 as in
    tests/test_tc_impls.py:170 so the 1e-4 variance floor and the -50
    clamp are both active (checked)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    z = rng.randn(b, Z_DIM).astype(np.float32)
    mu = rng.randn(b, Z_DIM).astype(np.float32)
    logvar = (rng.randn(b, Z_DIM) * 0.7 * 4.0).astype(np.float32)
    v = np.maximum(np.exp(logvar), 1e-4)
    lp = -0.5 * (np.log(v)[:, None] + (z[:, None] - mu[None]) ** 2 / v[:, None]
                 + np.log(2 * np.pi))
    if not ((np.exp(logvar) < 1e-4).any() and (lp < -50).any()):
        die(f"B={b}: inputs do not reach the variance floor and the clamp")
    return z, mu, logvar


def tc_loss(pm, qz):
    # weights the two outputs differently so both incoming gradients matter
    return (qz - pm).mean() + 0.5 * pm.sum() * 1e-3


def phase_kernels(card: str) -> dict:
    """Phase 3: each kernel against the plain version; returns per-kernel
    max_abs_err (over both B) and times at the main path's B.

    The plain version is evaluated in float64 on the same float32 inputs:
    in float32 it carries ~4e-5 of rounding on small gradient entries
    where the variance is floored (see csrc/tc_kernels.cu, "Precision"),
    more than the 1e-5 held here. Its float32 difference is printed too.
    """
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.ops import tc_cuda

    dev = torch.device("cuda", 0)
    errs = dict.fromkeys(tc_cuda.KERNELS, 0.0)
    times = {}
    owner = {"pm": "tc_fwd", "qz": "tc_fwd", "dz": "tc_bwd_dz",
             "dlogvar": "tc_bwd_dz", "dmu": "tc_bwd_dmu"}
    for b in (MAIN_B, 512):
        arrays = tc_inputs(b, seed=b)
        results = []
        for fn, dtype in ((tc_cuda.tc_logsumexp_cuda, torch.float32),
                          (tc_cuda.tc_logsumexp_reference, torch.float64),
                          (tc_cuda.tc_logsumexp_reference, torch.float32)):
            args = [torch.tensor(a, device=dev, dtype=dtype, requires_grad=True)
                    for a in arrays]
            pm, qz = fn(*args, DATASET_SIZE)
            tc_loss(pm, qz).backward()
            torch.cuda.synchronize()
            z, mu, logvar = args
            results.append({k: v.detach().double().cpu().numpy() for k, v in
                            {"pm": pm, "qz": qz, "dz": z.grad, "dmu": mu.grad,
                             "dlogvar": logvar.grad}.items()})
        got, want, plain32 = results
        for key, kernel in owner.items():
            g, w = got[key], want[key]
            if not np.isfinite(g).all():
                die(f"{kernel}: non-finite {key} at B={b}")
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kernel} {key} B={b}")
            errs[kernel] = max(errs[kernel], float(np.abs(g - w).max()))
        print(f"phase 3: B={b}: max abs diff to the float64 plain version: kernels "
              + json.dumps({k: float(np.abs(got[k] - want[k]).max()) for k in owner})
              + ", float32 plain version "
              + json.dumps({k: float(np.abs(plain32[k] - want[k]).max()) for k in owner}))

        # times: each kernel launched alone, and the float32 plain forward and
        # backward (what tc_impl 'xla' runs)
        z, mu, logvar = (torch.tensor(a, device=dev) for a in arrays)
        f64 = dict(device=dev, dtype=torch.float64)
        lm, lj = torch.empty((b, Z_DIM), **f64), torch.empty(b, **f64)
        pm, qz = torch.empty(b, device=dev), torch.empty(b, device=dev)
        g_m = torch.full((b,), -1.0 / b + 5e-4, device=dev)
        g_j = torch.full((b,), 1.0 / b, device=dev)
        dz, dlv, dmu = torch.empty_like(z), torch.empty_like(z), torch.empty_like(z)
        launch = tc_cuda.launch
        t = {
            "tc_fwd": median_ms(lambda: launch("tc_fwd", (z, mu, logvar, lm, lj, pm, qz),
                                               b, b, Z_DIM, DATASET_SIZE, dev)),
            "tc_bwd_dz": median_ms(lambda: launch(
                "tc_bwd_dz", (z, mu, logvar, lm, lj, g_m, g_j, dz, dlv),
                b, b, Z_DIM, DATASET_SIZE, dev)),
            "tc_bwd_dmu": median_ms(lambda: launch(
                "tc_bwd_dmu", (z, mu, logvar, lm, lj, g_m, g_j, dmu),
                b, b, Z_DIM, DATASET_SIZE, dev)),
        }
        with torch.no_grad():
            t["plain_fwd"] = median_ms(
                lambda: tc_cuda.tc_logsumexp_reference(z, mu, logvar, DATASET_SIZE))
        args = [x.clone().requires_grad_(True) for x in (z, mu, logvar)]
        loss = tc_loss(*tc_cuda.tc_logsumexp_reference(*args, DATASET_SIZE))
        t["plain_bwd"] = median_ms(lambda: torch.autograd.grad(loss, args, retain_graph=True))
        print(f"phase 3: B={b} Z={Z_DIM} N={DATASET_SIZE} median ms per call "
              + json.dumps({k: round(v, 5) for k, v in t.items()})
              + f" on {card}")
        if b == MAIN_B:
            times = t
    print("phase 3: kernels match the plain version (rtol 1e-4, atol 1e-5, TF32 off); "
          "max abs err " + json.dumps(errs))
    return {"errs": errs, "times": times}


def conv_bound(name: str, dtype, ref, s):
    """Largest |kernel - float64 plain| allowed per entry; s is the same
    conv of the operands' absolute values (each entry's sum of |terms|).

    fp32: rtol 1e-4 / atol 1e-5 for y and dx (576 terms an entry). dW sums
    524,288 products at [128, 64, 64, 64] in at most 2,304 sequential fp32
    additions an entry (8 tiles x 256 pixels in a block, then 256
    partials): the random-walk estimate sqrt(2304) * 2^-24 = 2.9e-6 s,
    with a 7x margin, under the worst case 2304 * 2^-24 = 1.4e-4 s, gives
    2e-5 s. bf16: one rounding of the fp32 sum, at most 2^-8 |ref| (bf16
    keeps 8 significant bits), plus 1e-5 s for the fp32 sum before it."""
    import torch

    if dtype == torch.bfloat16:
        return 2.0 ** -8 * ref.abs() + 1e-5 * s
    if name == "dw":
        return 2e-5 * s
    return RTOL * ref.abs() + ATOL


def phase_conv_kernels(card: str) -> dict:
    """Phase 3, conv: each kernel against the float64 plain version at the
    flagship's shapes in fp32 and bf16 (TF32 off); returns per-kernel
    max_abs_err over all checks and the bf16 times at [128, 64, 64, 64]."""
    import torch

    from intro_tc_vae_tpu_torch.ops import conv, conv_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = dict.fromkeys(conv_cuda.KERNELS, 0.0)
    owner = {"y": "conv3x3_fwd", "dx": "conv3x3_fwd", "dw": "conv3x3_dw"}
    for shape in CONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=dev, generator=gen) * 0.5).to(dtype)
            w = (torch.randn((64, 64, 3, 3), device=dev, generator=gen) * 0.05).to(dtype)
            gy = torch.randn(shape, device=dev, generator=gen).to(dtype)
            got = {"y": conv_cuda.conv3x3_fwd(x, w),
                   "dx": conv_cuda.conv3x3_fwd(gy, conv.rot_t(w).contiguous()),
                   "dw": conv_cuda.conv3x3_dw(x, gy)}
            torch.cuda.synchronize()
            xd, wd, gd = x.double(), w.double(), gy.double()
            want = {
                "y": (conv.conv3x3_reference(xd, wd),
                      conv.conv3x3_reference(xd.abs(), wd.abs())),
                "dx": (conv.conv3x3_dx_reference(gd, wd),
                       conv.conv3x3_dx_reference(gd.abs(), wd.abs())),
                "dw": (conv.conv3x3_dw_reference(xd, gd),
                       conv.conv3x3_dw_reference(xd.abs(), gd.abs())),
            }
            report = {}
            for name, (ref, s) in want.items():
                g = got[name]
                if g.dtype != dtype or g.shape != ref.shape or not bool(torch.isfinite(g).all()):
                    die(f"{owner[name]} {name} {shape} {dtype}: dtype {g.dtype}, shape "
                        f"{tuple(g.shape)}, or non-finite values")
                d = (g.double() - ref).abs()
                ratio = float((d / conv_bound(name, dtype, ref, s)).max())
                err = float(d.max())
                report[name] = {"max_abs": err, "max_over_bound": ratio}
                if ratio > 1.0:
                    die(f"{owner[name]} {name} {shape} {dtype}: max |d| {err:.4g} is "
                        f"{ratio:.3g} x the bound")
                errs[owner[name]] = max(errs[owner[name]], err)
                if name == "dw":
                    errs["conv3x3_dw_reduce"] = max(errs["conv3x3_dw_reduce"], err)
            print(f"phase 3: conv {list(shape)} {str(dtype)[6:]}: vs float64 plain "
                  + json.dumps(report))
    print("phase 3: conv kernels match the float64 plain version (fp32: rtol 1e-4 / atol "
          "1e-5 for y and dx, 2e-5 S for dW; bf16: 2^-8 |ref| + 1e-5 S)")

    # times at bf16, with the settings the main path runs under (torch's
    # defaults: no cuDNN autotuning, TF32 irrelevant for bf16)
    times = {}
    for shape in CONV_SHAPES:
        x = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        w = torch.randn((64, 64, 3, 3), device=dev, dtype=torch.bfloat16) * 0.05
        gy = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        n, _, h, wd = shape
        tiles = n * -(-h // conv_cuda.TILE_H) * -(-wd // conv_cuda.TILE_W)
        n_parts = min(tiles, conv_cuda.MAX_PARTS)
        part = torch.empty((n_parts, 576, 64), device=dev)
        dw = torch.empty((64, 64, 3, 3), device=dev, dtype=torch.bfloat16)
        launch = conv_cuda.launch
        t = {
            "conv3x3_fwd": median_ms(lambda: conv_cuda.conv3x3_fwd(x, w)),
            "conv3x3_dw": median_ms(lambda: launch(
                "conv3x3_dw", x, gy, part, n, h, wd, n_parts, 1, device=dev)),
            "conv3x3_dw_reduce": median_ms(lambda: launch(
                "conv3x3_dw_reduce", part, dw, n_parts, 1, device=dev)),
            "cudnn_fwd": median_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
            "cudnn_dgrad": median_ms(
                lambda: torch.nn.grad.conv2d_input(shape, w, gy, padding=1)),
            "cudnn_wgrad": median_ms(
                lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1)),
        }
        print(f"phase 3: conv {list(shape)} bf16 median ms per call "
              + json.dumps({k: round(v, 5) for k, v in t.items()}) + f" on {card}")
        if shape == CONV_SHAPES[0]:
            times = t
    return {"errs": errs, "times": times}


def all_launches() -> dict:
    from intro_tc_vae_tpu_torch.ops import conv_cuda, tc_cuda

    return {**tc_cuda.LAUNCHES, **conv_cuda.LAUNCHES}


def reset_all_launches() -> None:
    from intro_tc_vae_tpu_torch.ops import conv_cuda, tc_cuda

    tc_cuda.reset_launch_counts()
    conv_cuda.reset_launch_counts()


def expected_intro_launches(tc_impl: str, conv_impl: str) -> tuple:
    """Launches in phase E and in phase D of one paired flagship step,
    derived from the pass list of solvers/intro.py.

    TC: one call per KL term: real, rec, fake in phase E, rec, fake in
    phase D; each call's loss is differentiated, so each launches tc_fwd,
    tc_bwd_dz and tc_bwd_dmu once: 3 and 2.
    Conv: the decoder routes 3 convs (res_in_32.conv2, res_in_64.conv1,
    .conv2); the encoder none. Each phase makes 2 paired decoder calls.
    Every routed conv launches conv3x3_fwd for its forward ('pallas' only)
    and for its dx (both: its input depends on the decoder's fc weights or
    on z). conv3x3_dw and conv3x3_dw_reduce launch once per routed conv of
    the network the phase updates: 0 in phase E (the decoder is frozen),
    2 calls x 3 = 6 in phase D."""
    tc = 1 if tc_impl == "pallas" else 0
    fwd_per_conv = {"pallas": 2, "hybrid": 1, "xla": 0}[conv_impl]
    dw = 6 if conv_impl != "xla" else 0

    def counts(tc_calls, fwd, dws):
        return {"tc_fwd": tc_calls * tc, "tc_bwd_dz": tc_calls * tc,
                "tc_bwd_dmu": tc_calls * tc, "conv3x3_fwd": fwd,
                "conv3x3_dw": dws, "conv3x3_dw_reduce": dws}

    per_phase = 2 * 3 * fwd_per_conv
    return counts(3, per_phase, 0), counts(2, per_phase, dw)


@contextlib.contextmanager
def launches_per_phase():
    """Sums the launches of phase E and of phase D over the steps of an
    intro run: each step calls the encoder's optimizer at the end of phase
    E and the decoder's at the end of phase D; a global optimizer pre-hook
    reads the counters at each call."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    sums = [dict.fromkeys(all_launches(), 0), dict.fromkeys(all_launches(), 0)]
    state = {"last": all_launches(), "calls": 0}

    def hook(optimizer, args, kwargs):
        now = all_launches()
        phase = sums[state["calls"] % 2]
        for k in now:
            phase[k] += now[k] - state["last"][k]
        state["last"], state["calls"] = now, state["calls"] + 1

    handle = register_optimizer_step_pre_hook(hook)
    try:
        yield sums
    finally:
        handle.remove()


def run_cli(config: str, update: dict, name: str):
    """20 steps through the CLI; checks the step count and that every
    recorded value is finite; returns the final TrainState."""
    from intro_tc_vae_tpu_torch import main

    state = main.cli(["-f", config, "-u", json.dumps(update)])
    if len(state.history) != 20:
        die(f"{name}: {len(state.history)} steps, expected 20")
    for rec in state.history:
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                die(f"{name}: non-finite {k} at step {rec['step']}")
    return state


INTRO_ARMS = (("pallas", "xla"), ("xla", "xla"), ("pallas", "pallas"), ("pallas", "hybrid"))


def phase_main_path(card: str) -> dict:
    """Phase 4: the CLI trains 20 flagship steps in each of INTRO_ARMS."""
    from intro_tc_vae_tpu_torch.train import images_per_second

    rates, launches = {}, {}
    for tc_impl, conv_impl in INTRO_ARMS:
        arm = f"tc {tc_impl}, conv {conv_impl}"
        update = {"dataset": "synthetic", "tc_impl": tc_impl, "conv_impl": conv_impl,
                  "num_epochs": 1, "use_tensorboard": False}
        reset_all_launches()
        with launches_per_phase() as (phase_e, phase_d):
            state = run_cli(FLAGSHIP, update, arm)
        counts = all_launches()
        want_e, want_d = expected_intro_launches(tc_impl, conv_impl)
        for label, got, want in (("phase E", phase_e, want_e), ("phase D", phase_d, want_d),
                                 ("total", counts,
                                  {k: want_e[k] + want_d[k] for k in want_e})):
            want20 = {k: 20 * v for k, v in want.items()}
            if got != want20:
                die(f"{arm}: {label} launches {got}, expected {want20}")
        rates[arm] = images_per_second(state, MAIN_B)
        launches[arm] = counts
        last = state.history[-1]
        print(f"phase 4: {arm}: 20 steps, finite losses (last lossE {last['lossE']:.6g} "
              f"lossD {last['lossD']:.6g}); launches phase E {phase_e}, phase D {phase_d}")
    print("phase 4: img/s (steps 4-20, bf16, batch 64) "
          + json.dumps({k: round(v, 1) for k, v in rates.items()}) + f" on {card}")
    return {"rates": rates, "launches": launches["tc pallas, conv pallas"]}


@contextlib.contextmanager
def plain_tc_in_float64():
    """tc_impl 'xla' evaluates the plain TC version in float64 on the same
    float32 inputs and returns float32, as phase 3 holds the kernels to it."""
    import torch

    from intro_tc_vae_tpu_torch.ops import tc

    plain = tc.tc_logsumexp_reference

    def plain64(z, mu, logvar, dataset_size):
        pm, qz = plain(z.double(), mu.double(), logvar.double(), dataset_size)
        return pm.float(), qz.float()

    tc.tc_logsumexp_reference = plain64
    try:
        yield
    finally:
        tc.tc_logsumexp_reference = plain


def phase_in_context(dev) -> None:
    """Phase 5: one fp32 step with the kernels vs one with the plain
    versions, from the same weights, batch and noise: (a) the TC kernels,
    (b) the conv kernels; (c) the flagship decoder alone.

    (a) TC by the kernels vs by the plain version.

    The plain version runs in float64 inside the step (its inputs and
    outputs stay float32): in float32 its softmax weights exp(iw + sum_l P
    - lj), with |sum_l P| in the thousands, carry ~1e-4 of rounding, which
    reaches the parameter gradients, and Adam's first update, about
    lr * sign(g), turns it into whole-update differences (up to 2 * lr) on
    entries whose gradient is near 0. The float32 plain step's difference
    is printed too.
    """
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS, make_optimizer, make_solver

    cfg = load_config(FLAGSHIP, {"dataset": "synthetic", "precision": "fp32"})
    ds, image_size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=channels,
              image_size=image_size, compute_dtype=torch.float32)
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).state_dict()
    batch = torch.from_numpy(ds.get_batch(np.arange(MAIN_B)).transpose(0, 3, 1, 2).copy())
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = {k: torch.randn((MAIN_B, cfg.z_dim), generator=gen, device=dev)
             for k in NOISE_KEYS}
    def one_step(impl: str, conv_impl: str = "xla"):
        model = SoftIntroVAE(Encoder(**kw, conv_impl=conv_impl),
                             Decoder(**kw, conv_impl=conv_impl))
        model.load_state_dict(init)
        model.to(dev)
        solver = make_solver(
            "intro_tc", dataset=ds, encoder=model.encoder, decoder=model.decoder,
            batch_size=MAIN_B, optimizer_e=make_optimizer("adam", cfg.lr),
            optimizer_d=make_optimizer("adam", cfg.lr),
            recon_loss_type=cfg.recon_loss_type, beta_kl=cfg.beta_kl,
            beta_rec=cfg.beta_rec, beta_neg=cfg.beta_neg, gamma_r=cfg.gamma_r,
            tc_impl=impl, fuse_passes=True)
        state = solver.init_state(0)
        state, metrics = solver.train_step(state, batch.to(dev), noise=noise)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})

    def params_diff(p_a, p_b):
        worst = max(float(np.abs(p_a[k] - p_b[k]).max()) for k in p_b)
        n_over = sum(int((np.abs(p_a[k] - p_b[k]) > ATOL).sum()) for k in p_b)
        return worst, n_over

    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    m_k, p_k = one_step("pallas")
    with plain_tc_in_float64():
        m_x, p_x = one_step("xla")
    m_32, p_32 = one_step("xla")

    n_params = sum(v.size for v in p_x.values())
    worst32, over32 = params_diff(p_32, p_x)
    print(f"phase 5: float32 plain TC step vs float64 plain TC step: metrics max rel "
          f"{max(abs(m_32[n] - m_x[n]) / abs(m_x[n]) for n in names):.3g}; updated "
          f"params max abs diff {worst32:.3g}, {over32} of {n_params} entries over {ATOL}")
    for name in names:
        if not math.isclose(m_k[name], m_x[name], rel_tol=RTOL, abs_tol=1e-30):
            die(f"phase 5: {name} pallas {m_k[name]!r} vs xla {m_x[name]!r}")
    worst, n_over = params_diff(p_k, p_x)
    print(f"phase 5: kernel step vs float64 plain TC step: updated params max abs "
          f"diff {worst:.3g}, {n_over} of {n_params} entries over {ATOL}")
    for k in p_x:
        np.testing.assert_allclose(p_k[k], p_x[k], rtol=0, atol=ATOL, err_msg=f"phase 5: {k}")
    print("phase 5: one fp32 step (TF32 off), pallas vs xla: metrics within rtol 1e-4 "
          + json.dumps({n: [m_k[n], m_x[n]] for n in names})
          + f"; updated params max abs diff {worst:.3g} (atol 1e-5)")

    # (b) the conv kernels in the step: both steps run the TC kernels
    m_c, p_c = one_step("pallas", conv_impl="pallas")
    for name in names:
        if not math.isclose(m_c[name], m_k[name], rel_tol=RTOL, abs_tol=1e-30):
            die(f"phase 5: conv pallas {name} {m_c[name]!r} vs conv xla {m_k[name]!r}")
    worst, n_over = params_diff(p_c, p_k)
    if not worst <= 2 * LR:
        die(f"phase 5: conv pallas vs xla: updated params differ by {worst!r} > 2 lr")
    print("phase 5: one fp32 step (TF32 off), conv_impl pallas vs xla: metrics within "
          "rtol 1e-4 " + json.dumps({n: [m_c[n], m_k[n]] for n in names})
          + f"; updated params max abs diff {worst:.3g} (<= 2 lr = {2 * LR:g}), "
          f"{n_over} of {n_params} entries over {ATOL}")

    # (c) the flagship decoder alone, at the paired shape of the main path
    phase_decoder(dev, kw, {k: v for k, v in init.items() if k.startswith("decoder.")})


def phase_decoder(dev, kw: dict, init: dict) -> None:
    """Phase 5 (c): the flagship decoder's forward and backward in fp32,
    conv_impl 'pallas' and 'xla' (cuDNN, TF32 off), each against the
    float64 decoder (cuDNN in float64), same weights and z [128, 128] as
    two groups of 64 (a paired call), in train and in eval mode; the
    gradients are those of sum(y * c), c ~ N(0, 1).

    Tolerances: the output within 1e-5 of float64 (sigmoid values in
    [0, 1]); each parameter gradient's max |d| to float64 at most 2x the
    stock fp32 decoder's plus 1e-4 of the tensor's largest entry. The two
    fp32 decoders are not held to each other: through five blocks of
    LeakyReLU kinks and, in train mode, BatchNorm's fp32 variance
    E[x^2] - E[x]^2, which cancels, both land some 1e-2 of the largest
    entry away from float64 in their deepest gradients (res_in_8.conv1,
    the fc), and as far from each other (on an H100 80GB HBM3 the direct
    comparison failed at 12-18x a 1e-3 / 1e-4 bound)."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.models import Decoder

    gen = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn((2 * MAIN_B, kw["zdim"]), generator=gen, device=dev)
    cot = torch.randn((2 * MAIN_B, kw["cdim"], kw["image_size"], kw["image_size"]),
                      generator=gen, device=dev)

    def run(conv_impl, train, dtype=torch.float32):
        dec = Decoder(**{**kw, "compute_dtype": dtype}, conv_impl=conv_impl)
        dec.load_state_dict({k[len("decoder."):]: v for k, v in init.items()})
        dec.to(dev).to(dtype).train(train)
        y = dec(z.to(dtype), groups=2)
        names, params = zip(*dec.named_parameters())
        grads = torch.autograd.grad((y.to(dtype) * cot.to(dtype)).sum(), params)
        torch.cuda.synchronize()
        return (y.detach().double().cpu().numpy(),
                {n: g.double().cpu().numpy() for n, g in zip(names, grads)})

    for mode, train in (("train", True), ("eval", False)):
        (y_k, g_k), (y_x, g_x) = run("pallas", train), run("xla", train)
        y_64, g_64 = run("xla", train, torch.float64)
        dy_k, dy_x = float(np.abs(y_k - y_64).max()), float(np.abs(y_x - y_64).max())
        if not dy_k <= 1e-5:
            die(f"phase 5: {mode} decoder output pallas vs float64 differs by {dy_k!r}")
        rel = {}
        for n, ref in g_64.items():
            scale = float(np.abs(ref).max())
            d_k = float(np.abs(g_k[n] - ref).max())
            d_x = float(np.abs(g_x[n] - ref).max())
            if not d_k <= 2 * d_x + 1e-4 * scale:
                die(f"phase 5: {mode} decoder grad {n}: |pallas - f64| {d_k:.4g} > 2 x "
                    f"|xla - f64| {d_x:.4g} + 1e-4 x {scale:.4g}")
            rel[n] = (d_k / scale, d_x / scale)
        top = sorted(rel.items(), key=lambda kv: -kv[1][0])[:3]
        print(f"phase 5: decoder fwd+bwd fp32, {mode} mode, vs float64: output max abs "
              f"diff pallas {dy_k:.3g}, xla {dy_x:.3g} (<= 1e-5); {len(rel)} gradients "
              f"within 2x xla's distance + 1e-4 max|g|; largest max|d|/max|g| "
              "(pallas, xla): " + json.dumps({n: [round(a, 6), round(b, 6)]
                                             for n, (a, b) in top}))


def phase_other_paths(card: str) -> None:
    """Phase 6: vae_synthetic.json and tc_dsprites.json (synthetic data)
    through the CLI, 20 steps each with conv_impl 'pallas' and 'xla'.

    Derived per step (one forward, both networks differentiated): the
    decoder routes the same 3 convs as the flagship's (the res arch's
    res_in_32 and res_in_64 have the conv arch's 3x3 convs), each launching
    conv3x3_fwd for its forward and for its dx, and conv3x3_dw and
    conv3x3_dw_reduce once: 6, 3, 3. tc: one TC call, differentiated: 1 of
    each TC kernel."""
    from intro_tc_vae_tpu_torch.train import images_per_second

    rates = {}
    for label, config, update, tc in (
            ("vae_synthetic (res, vae)", VAE_SYNTHETIC, {}, 0),
            ("tc_dsprites (conv, tc)", TC_DSPRITES,
             {"dataset": "synthetic", "tc_impl": "pallas", "use_tensorboard": False}, 1)):
        for conv_impl in ("pallas", "xla"):
            run = f"{label}, conv {conv_impl}"
            k = 1 if conv_impl == "pallas" else 0
            want = {"tc_fwd": 20 * tc, "tc_bwd_dz": 20 * tc, "tc_bwd_dmu": 20 * tc,
                    "conv3x3_fwd": 20 * 6 * k, "conv3x3_dw": 20 * 3 * k,
                    "conv3x3_dw_reduce": 20 * 3 * k}
            reset_all_launches()
            state = run_cli(config, {**update, "conv_impl": conv_impl, "num_epochs": 1}, run)
            counts = all_launches()
            if counts != want:
                die(f"{run}: launches {counts}, expected {want}")
            rates[run] = images_per_second(state, MAIN_B)
            print(f"phase 6: {run}: 20 steps, finite losses (last loss "
                  f"{state.history[-1]['loss_enc']:.6g}), launches {counts}")
    print("phase 6: img/s (steps 4-20, fp32, batch 64) "
          + json.dumps({k: round(v, 1) for k, v in rates.items()}) + f" on {card}")


def main() -> None:
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    try:
        import intro_tc_vae_tpu_torch
    except ImportError:
        die("intro_tc_vae_tpu_torch not found: run from the root of a checkout")
    if os.path.dirname(os.path.dirname(os.path.abspath(intro_tc_vae_tpu_torch.__file__))) != HERE:
        die(f"intro_tc_vae_tpu_torch imported from {intro_tc_vae_tpu_torch.__file__}, "
            "not from this checkout")

    # ---- phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1: device {name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible")
    print(card)  # nvidia-smi's name, power.limit

    # ---- phase 2: build from the checkout's sources, one nvcc per source
    from concurrent.futures import ThreadPoolExecutor

    from intro_tc_vae_tpu_torch.ops import conv_cuda, cuda_build, tc_cuda

    for lib in LIBRARIES:
        path = cuda_build.library_path(lib)
        if path.exists():
            path.unlink()  # always compile this checkout's source
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(cuda_build.build, LIBRARIES))
    tc_cuda._library()
    conv_cuda._library()
    for path, seconds in built:
        print(f"phase 2: built {os.path.relpath(path, HERE)} in {seconds:.1f} s")

    with fp32_exact():
        kernels = phase_kernels(card)
        conv = phase_conv_kernels(card)
    main_path = phase_main_path(card)
    with fp32_exact():  # same conv algorithms in both runs
        phase_in_context(torch.device("cuda", 0))
    phase_other_paths(card)

    times = {**kernels["times"], **conv["times"]}
    plain = {"tc_fwd": "plain_fwd", "tc_bwd_dz": "plain_bwd", "tc_bwd_dmu": "plain_bwd",
             "conv3x3_fwd": "cudnn_fwd", "conv3x3_dw": "cudnn_wgrad",
             "conv3x3_dw_reduce": "cudnn_wgrad"}
    errs = {**kernels["errs"], **conv["errs"]}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k], "replaces": REPLACES[k],
         "launches": main_path["launches"][k], "max_abs_err": errs[k],
         "ms": times[k], "plain_ms": times[plain[k]]}
        for k in (*tc_cuda.KERNELS, *conv_cuda.KERNELS)
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
