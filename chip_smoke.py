#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (intro_tc_vae_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: compiles the TC kernels (intro_tc_vae_tpu_torch/csrc/
   tc_kernels.cu) from the checkout's sources and loads them.
3. Kernel vs plain, TF32 off: tc_fwd, tc_bwd_dz and tc_bwd_dmu against the
   plain PyTorch version (evaluated in float64 on the same inputs) on the
   card at B in {64, 512}, Z=128, N=1280, with the variance floor and the
   -50 clamp active; rtol 1e-4, atol 1e-5 on every element. Median times
   of each kernel and of the float32 plain version.
4. Main path: ``intro_tc_vae_tpu_torch.main.cli`` trains the flagship
   recipe (configs/intro_tc_ukiyo64.json: 64x64x3, conv arch, channels
   64-512, z=128, batch 64, bf16, paired) on the synthetic dataset for one
   epoch = 20 steps with tc_impl 'pallas', then with 'xla'. Every loss is
   finite; the kernels' launch counters rise by exactly 100 each (5 TC
   sites x 20 steps) in the 'pallas' run and not at all in the 'xla' run.
   Both rates in img/s, steps after the first 3.
5. Kernel in context, fp32, TF32 off: one step with tc_impl 'pallas' and
   one with 'xla' from the same weights, batch and noise agree (metrics
   rtol 1e-4, updated parameters atol 1e-5). As in phase 3, the 'xla'
   step evaluates the plain TC version in float64; the all-float32 'xla'
   step's distance is printed beside it.

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
KERNEL_SOURCE = "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu"
REPLACES = {
    "tc_fwd": "intro_tc_vae_tpu/ops/tc_pallas.py:109",
    "tc_bwd_dz": "intro_tc_vae_tpu/ops/tc_pallas.py:174",
    "tc_bwd_dmu": "intro_tc_vae_tpu/ops/tc_pallas.py:202",
}
RTOL, ATOL = 1e-4, 1e-5
Z_DIM, DATASET_SIZE, MAIN_B = 128, 1280, 64


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


def phase_main_path(card: str) -> dict:
    """Phase 4: the CLI trains 20 steps with tc_impl 'pallas', then 'xla'."""
    from intro_tc_vae_tpu_torch import main
    from intro_tc_vae_tpu_torch.ops import tc_cuda
    from intro_tc_vae_tpu_torch.train import images_per_second

    rates, launches = {}, {}
    for impl in ("pallas", "xla"):
        update = {"dataset": "synthetic", "tc_impl": impl, "num_epochs": 1,
                  "use_tensorboard": False}
        tc_cuda.reset_launch_counts()
        state = main.cli(["-f", FLAGSHIP, "-u", json.dumps(update)])
        counts = dict(tc_cuda.LAUNCHES)
        if len(state.history) != 20:
            die(f"{impl}: {len(state.history)} steps, expected 20")
        for rec in state.history:
            for k, v in rec.items():
                if isinstance(v, float) and not math.isfinite(v):
                    die(f"{impl}: non-finite {k} at step {rec['step']}")
        want = 100 if impl == "pallas" else 0
        if counts != dict.fromkeys(tc_cuda.KERNELS, want):
            die(f"{impl}: kernel launches {counts}, expected {want} each")
        rates[impl] = images_per_second(state, MAIN_B)
        launches[impl] = counts
        last = state.history[-1]
        print(f"phase 4: tc_impl={impl}: 20 steps, finite losses (last lossE "
              f"{last['lossE']:.6g} lossD {last['lossD']:.6g}), kernel launches {counts}")
    print(f"phase 4: img/s (steps 4-20, bf16, batch 64): pallas {rates['pallas']:.1f}, "
          f"xla {rates['xla']:.1f} on {card}")
    return {"rates": rates, "launches": launches["pallas"]}


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
    """Phase 5: one fp32 step, TC by the kernels vs by the plain version.

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
    def one_step(impl: str):
        model = SoftIntroVAE(Encoder(**kw), Decoder(**kw))
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

    # ---- phase 2: build from the checkout's sources
    from intro_tc_vae_tpu_torch.ops import cuda_build, tc_cuda

    lib = cuda_build.library_path("tc_kernels")
    if lib.exists():
        lib.unlink()  # always compile this checkout's source
    path, seconds = cuda_build.build("tc_kernels")
    tc_cuda._library()
    print(f"phase 2: built {os.path.relpath(path, HERE)} in {seconds:.1f} s")

    with fp32_exact():
        kernels = phase_kernels(card)
    main_path = phase_main_path(card)
    with fp32_exact():  # same conv algorithms in both runs
        phase_in_context(torch.device("cuda", 0))

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[k],
         "launches": main_path["launches"][k], "max_abs_err": kernels["errs"][k],
         "ms": kernels["times"][k],
         "plain_ms": kernels["times"]["plain_fwd" if k == "tc_fwd" else "plain_bwd"]}
        for k in tc_cuda.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
