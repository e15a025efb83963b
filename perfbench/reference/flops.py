"""Operations of one train step and of one decode, counted over the
reference (``reference/model.py``) on the meta device, never over the
program: a change to the program cannot change what ``mfu.*`` divides by.

* Conv and dense products: ``torch.utils.flop_counter.FlopCounterMode``
  over the reference's step, every pass forward and each gradient the
  step takes (autograd computes only the weight gradients of the network a
  phase differentiates, and input gradients only where they lead to it).
* The TC term: its operations by the formula the TC kernels' bounds use
  (``core/peaks.py::TC_OPS``), per KL site forward and, where the site is
  differentiated (all five are), its two backward kernels.

Reconciliation (one flagship image, batch 64): the products are the same
conv and dense work that ``intro_tc_vae_tpu_torch/analysis/ceiling.py``
counts over the program's own step, 49.591 GFLOP an image at 64 px and
203.068 at 128 px (batch 64); ``perfbench/tests/test_pb_counts.py`` holds this count
to those figures.
"""

from __future__ import annotations

import functools

import torch

from perfbench.core.peaks import TC_OPS
from perfbench.reference.model import (NOISE_KEYS, Adam, Arch, Hyper, decoder,
                                       intro_tc_step, leaf_specs)

TC_SITES = 5  # real, rec and fake in the encoder phase; rec and fake in the decoder phase


def meta_weights(arch: Arch) -> dict:
    """The reference's leaves on the meta device: shapes without values."""
    meta = torch.device("meta")
    return {name: torch.empty(shape, device=meta) for name, shape, _, _ in leaf_specs(arch)}


def tc_site_ops(b: int, zdim: int) -> int:
    """One differentiated TC call over a batch of ``b`` (its own bank)."""
    return sum(b * b * (zdim * per_pair + per_row)
               for per_pair, per_row in TC_OPS.values())


@functools.lru_cache(maxsize=None)
def step_products(arch: Arch, batch: int) -> int:
    """Conv and dense operations of one intro step at ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    params = meta_weights(arch)
    h = Hyper(beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, gamma_r=1e-8, lr=2e-4,
              dataset_size=1000)
    x = torch.empty((batch, arch.cdim, arch.image_size, arch.image_size), device=meta)
    noise = {k: torch.empty((batch, arch.zdim), device=meta) for k in NOISE_KEYS}
    counter = FlopCounterMode(display=False)
    with counter:
        intro_tc_step(params, Adam(h.lr), Adam(h.lr), arch, h, x, noise)
    return int(counter.get_total_flops())


def step_flops_per_image(arch: Arch, batch: int) -> float:
    """Operations of one train step per image: products plus the TC's."""
    return (step_products(arch, batch) + TC_SITES * tc_site_ops(batch, arch.zdim)) / batch


@functools.lru_cache(maxsize=None)
def decode_flops_per_image(arch: Arch) -> float:
    """Operations of one eval-mode decode of one latent."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    params = meta_weights(arch)
    z = torch.empty((1, arch.zdim), device=meta)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        decoder(params, arch, z, stats=_unit_stats(params))
    return float(counter.get_total_flops())


def _unit_stats(params: dict) -> dict:
    """Running statistics of mean 0 and variance 1 for every BatchNorm."""
    out = {}
    for name, t in params.items():
        if name.endswith(".weight") and t.dim() == 1:
            prefix = name[: -len(".weight")]
            out[f"{prefix}.running_mean"] = torch.zeros_like(t)
            out[f"{prefix}.running_var"] = torch.ones_like(t)
    return out


# the program routes a 3x3 64 -> 64 conv without bias to its hand kernels
# when H % 16 == 0 (and is a multiple of min(H, 64)), W is even and >= 4
# and H * W <= 128^2 (a frozen copy of ``ops/conv.py::supported``)
def routed(x_shape, w_shape) -> bool:
    if tuple(w_shape) != (64, 64, 3, 3):
        return False
    _, c, h, w = x_shape
    return (c == 64 and h % 16 == 0 and h % min(h, 64) == 0 and w % 2 == 0 and w >= 4
            and h * w <= 128 * 128)


@functools.lru_cache(maxsize=None)
def conv_calls(arch: Arch, batch: int) -> tuple:
    """Every conv function one reference step computes: ("fwd" | "dx" |
    "dw", input shape, weight shape), the gradients as autograd's
    ``output_mask`` asks for them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is aten.convolution.default:
                calls.append(("fwd", tuple(args[0].shape), tuple(args[1].shape)))
            elif func is aten.convolution_backward.default:
                mask = args[10]
                for kind, wanted in zip(("dx", "dw"), mask[:2]):
                    if wanted:
                        calls.append((kind, tuple(args[1].shape), tuple(args[2].shape)))
            return func(*args, **(kwargs or {}))

    meta = torch.device("meta")
    params = meta_weights(arch)
    h = Hyper(beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, gamma_r=1e-8, lr=2e-4,
              dataset_size=1000)
    x = torch.empty((batch, arch.cdim, arch.image_size, arch.image_size), device=meta)
    noise = {k: torch.empty((batch, arch.zdim), device=meta) for k in NOISE_KEYS}
    with Record():
        intro_tc_step(params, Adam(h.lr), Adam(h.lr), arch, h, x, noise)
    return tuple(calls)


def routed_conv_bound_s(arch: Arch, batch: int, kind: str = "bf16") -> float:
    """Least seconds of one step's routed conv functions (forward, input
    and weight gradients, as the reference's step needs them)."""
    from perfbench.core.peaks import conv3x3_bound_s

    return sum(conv3x3_bound_s(x, kind) for _, x, w in conv_calls(arch, batch) if routed(x, w))


def tc_bound_s(arch: Arch, batch: int) -> float:
    """Least seconds of one step's TC kernels: five sites, each forward
    and both backward kernels, over the step's batch as its own bank."""
    from perfbench.core.peaks import tc_bounds_s

    return TC_SITES * sum(tc_bounds_s(batch, batch, arch.zdim).values())
