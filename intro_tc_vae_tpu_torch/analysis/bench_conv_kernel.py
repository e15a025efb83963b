"""Microbench: the routed 3x3 64 -> 64 conv's hand kernels against cuDNN.

Counterpart of ``analysis/bench_conv_kernel.py`` (the JAX package's), with
its ``--batch`` and ``--size`` (defaults 64 and 64) and its five arms, at
[B, 64, S, S] NCHW, weights [64, 64, 3, 3], bf16 on the card (float32 on
the CPU, as the JAX script takes float32 off the TPU):

* ``fwd xla``: cuDNN's forward (``F.conv2d``);
* ``fwd pallas``: the forward kernel (``ops/conv_cuda.py::conv3x3_fwd``);
* ``fwd+bwd xla``: cuDNN's forward and both gradients of
  sum(conv(x, w)^2);
* ``fwd+bwd pallas``: the kernels forward and backward
  (``conv3x3_pallas``: the forward kernel, its dx form, dW and its
  reduce);
* ``fwd+bwd hybrid``: cuDNN's forward, the kernels' backward
  (``conv3x3_hybrid``).

First the equality check on the device, with the JAX script's bound: the
hand kernels' forward, dx and dW against cuDNN's within a relative max
error of 3e-2 (bf16 has 8 mantissa bits; an fp32-accumulated contraction
of bf16 operands stays a few ULPs from cuDNN's). Then the launch check:
one call of each arm launches exactly the hand kernels it names
(``conv_cuda.LAUNCHES``) and the cuDNN arms none; a failed check exits
with 1. Then each arm's median time (``analysis/_timing.py``: CUDA events
around 10 calls behind a device sleep) in us and TFLOP/s, from the JAX
script's FLOP count (2 B S^2 64 64 9, three times that for fwd+bwd). The
JAX script's ``--tile-h`` has no counterpart: the port's tiling is
``ops/conv.py::tile_schedule``'s. The last line is one JSON object.

    python -m intro_tc_vae_tpu_torch.analysis.bench_conv_kernel [--batch 64] [--size 64]

Runs on the card unless ``--device cpu``, where the wrappers take their
plain versions (the check then holds the plain conv to ``F.conv2d`` and
no kernel launches).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

REL_TOL = 3e-2  # the JAX script's bound (analysis/bench_conv_kernel.py:116)
REPS = 21       # timed samples of each arm


def inputs(batch: int, size: int, dtype, device):
    """The JAX script's x [B, S, S, 64] * 0.5 and w [3, 3, 64, 64] * 0.05
    (RandomState(0)), as NCHW and OIHW tensors."""
    import torch

    rng = np.random.RandomState(0)
    x = rng.randn(batch, size, size, 64) * 0.5
    w = rng.randn(3, 3, 64, 64) * 0.05
    x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(device=device, dtype=dtype)
    w = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(device=device, dtype=dtype)
    return x.contiguous(), w.contiguous()


def arms() -> dict:
    """name -> (fn(x, w), forward and backward?)."""
    import torch.nn.functional as F

    from intro_tc_vae_tpu_torch.ops import conv_cuda

    return {"fwd xla": (lambda x, w: F.conv2d(x, w, padding=1), False),
            "fwd pallas": (conv_cuda.conv3x3_fwd, False),
            "fwd+bwd xla": (lambda x, w: F.conv2d(x, w, padding=1), True),
            "fwd+bwd pallas": (conv_cuda.conv3x3_pallas, True),
            "fwd+bwd hybrid": (conv_cuda.conv3x3_hybrid, True)}


def call(fn, grad: bool, x, w):
    """One call of an arm: the forward, or the gradients of
    sum(conv(x, w)^2) with respect to x and w."""
    import torch

    if not grad:
        return fn(x, w)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    loss = (fn(xg, wg).float() ** 2).sum()
    return torch.autograd.grad(loss, (xg, wg))


def expected_launches(name: str, shape, dtype, cuda: bool) -> dict:
    """The hand kernels one call of arm ``name`` launches: none for the
    cuDNN arms (and none anywhere on the CPU); per forward (the output,
    and dx as the forward of the rotated weights) one forward kernel and
    one weight pack, per dW one dW kernel and its reduce."""
    from intro_tc_vae_tpu_torch.ops import conv

    body = conv.kernel_body(shape, dtype)
    fwd = "conv3x3_fwd" if body == "fp32" else f"conv3x3_fwd_{body}"
    dw = "conv3x3_dw" if body == "fp32" else f"conv3x3_dw_{body}"
    fwds, dws = {"fwd pallas": (1, 0), "fwd+bwd pallas": (2, 1),
                 "fwd+bwd hybrid": (1, 1)}.get(name, (0, 0))
    if not cuda:
        fwds = dws = 0
    out = {fwd: fwds, "conv3x3_pack_w": fwds, dw: dws, "conv3x3_dw_reduce": dws}
    return {k: v for k, v in out.items() if v}


def check(x, w) -> dict:
    """{fwd, dx, dw: (max |kernel - cuDNN|, max |cuDNN|, relative)}."""
    import torch.nn.functional as F

    from intro_tc_vae_tpu_torch.ops import conv_cuda

    y_k = conv_cuda.conv3x3_fwd(x, w).float()
    y_c = F.conv2d(x, w, padding=1).float()
    g_k = call(conv_cuda.conv3x3_pallas, True, x, w)
    g_c = call(lambda a, b: F.conv2d(a, b, padding=1), True, x, w)
    out = {}
    for name, a, b in (("fwd", y_k, y_c), ("dx", g_k[0].float(), g_c[0].float()),
                       ("dw", g_k[1].float(), g_c[1].float())):
        err, ref = float((a - b).abs().max()), float(b.abs().max())
        out[name] = {"max_abs_err": err, "ref_max": ref, "rel": err / max(ref, 1e-9)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    from intro_tc_vae_tpu_torch.analysis._timing import median_ms
    from intro_tc_vae_tpu_torch.ops import conv_cuda, launch_counts

    device = torch.device(a.device)
    cuda = device.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    b, s = a.batch, a.size
    x, w = inputs(b, s, dtype, device)
    gflop = 2 * b * s * s * 64 * 64 * 9 / 1e9

    failed = []
    errs = check(x, w)
    for name, e in errs.items():
        print(f"max |pallas - xla| {name}: {e['max_abs_err']:.3e} (ref max "
              f"{e['ref_max']:.2f}, rel {e['rel']:.1e}, dtype {str(dtype)[6:]})")
        if not e["rel"] < REL_TOL:
            failed.append(f"{name}: pallas != cuDNN (rel {e['rel']:.3e} >= {REL_TOL})")

    rows = {}
    print(f"shape [B={b}, {s}x{s}, 64->64] 3x3 SAME, {gflop:.1f} GFLOP fwd, on {device}")
    for name, (fn, grad) in arms().items():
        launch_counts.reset()
        call(fn, grad, x, w)
        if cuda:
            torch.cuda.synchronize(device)
        launched = {k: v for k, v in conv_cuda.LAUNCHES.items() if v}
        want = expected_launches(name, tuple(x.shape), dtype, cuda)
        if launched != want:
            failed.append(f"{name}: one call launched {launched}, expected {want}")
        ms = median_ms(lambda: call(fn, grad, x, w), device, reps=REPS)
        g = 3 * gflop if grad else gflop
        rows[name] = {"us": ms * 1e3, "tflops": g / ms, "gflop": g, "launches": launched}
        print(f"  {name:16s} {ms * 1e3:9.1f} us  {g / ms:7.1f} TFLOP/s  launches "
              + json.dumps(launched))
    out = {"metric": "bench_conv_kernel", "batch": b, "size": s, "dtype": str(dtype),
           "device": str(device),
           "card": torch.cuda.get_device_name(device) if cuda else None,
           "check": errs, "equal": not any("pallas != cuDNN" in f for f in failed),
           "launches_ok": not any("launched" in f for f in failed), "arms": rows}
    print(json.dumps(out))
    if failed:
        print("FAILED: " + "; ".join(failed), file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
