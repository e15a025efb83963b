"""Solver core: hyperparameters, train state, optimizers, loss terms and a
lean ``VAESolver``.

Counterpart of ``intro_tc_vae_tpu/solvers/base.py``. Differences that
follow from PyTorch rather than from the model:

* Parameters and BatchNorm statistics live in the modules and are updated
  in place; ``TrainState`` holds the modules, the two optimizers (one per
  network, reference train.py:143-144) and the noise generator.
* ``make_optimizer`` returns a factory over parameters — the counterpart
  of an optax transform, which holds no state until ``init``.
* Noise comes from an explicit ``torch.Generator`` on the device, or is
  passed in (parity tests hand both packages the same draws).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Iterable, Optional, Sequence

import torch

from intro_tc_vae_tpu_torch import not_ported, ops
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE

# the 7-way key split of the JAX step (solvers/intro.py:81-83) minus the
# carried key: the step's six N(0, I) [B, z] draws, in this order
NOISE_KEYS = ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")

_OPTAX_NAMES = ("adam", "adamw", "adagrad", "adadelta", "sgd", "rmsprop",
                "lamb", "lion")


@dataclasses.dataclass(frozen=True)
class SolverHyper:
    """Solver hyperparameters."""

    recon_loss_type: str = "mse"
    beta_kl: float = 1.0
    beta_rec: float = 1.0
    beta_neg: float = 1.0
    gamma_r: float = 1e-8
    scale: float = 1.0              # 1 / (cdim * image_size^2), vae.py:61
    dataset_size: int = 1
    kl_kind: str = "gaussian"       # 'gaussian' | 'tc'
    tc_impl: str = "xla"            # 'xla' | 'pallas' (the CUDA kernels)
    tc_sampling: str = "stratified"
    clip: Optional[float] = None
    zdim: int = 32


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates. Parameters, BN statistics and optimizer
    moments are updated in place by the step; ``history`` collects the
    train loop's per-step host-side records."""

    step: int
    model: SoftIntroVAE
    opt_e: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    generator: torch.Generator
    history: list = dataclasses.field(default_factory=list)


def make_optimizer(name: str, lr: float) -> Callable[[Iterable], torch.optim.Optimizer]:
    """Optimizer factory by name. 'adam' is torch.optim.Adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8 — torch's too); the other optax
    names differ from torch's defaults and are not ported yet."""
    key = name.lower()
    if key == "adam":
        return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if key in _OPTAX_NAMES:
        raise not_ported(f"optimizer '{name}'", "Queue 1 item 6")
    raise ValueError(f"unknown optimizer '{name}' (known: {sorted(_OPTAX_NAMES)})")


def draw_noise(generator: torch.Generator, batch: int, zdim: int,
               device: torch.device) -> dict:
    return {k: torch.randn((batch, zdim), generator=generator, device=device)
            for k in NOISE_KEYS}


# ---------------------------------------------------------------------------
# loss terms
# ---------------------------------------------------------------------------

def kl_term(h: SolverHyper, z, mu, logvar, reduce: str = "mean", beta=None):
    """KL term with solver-dependent composition.

    'gaussian' (vae/intro): beta * KL
    'tc' (tc/intro_tc):     (beta-1)*TC + KL

    Returns (weighted loss, unscaled KL for the 'kl_loss_unscaled' tag).
    """
    if beta is None:
        beta = h.beta_kl
    if h.kl_kind not in ("gaussian", "tc"):
        raise not_ported(f"kl_kind='{h.kl_kind}'", "Queue 1 item 6")
    kl = ops.kl_divergence(logvar, mu, reduce=reduce)
    if h.kl_kind == "gaussian":
        return beta * kl, kl
    tc = ops.total_correlation(z, mu, logvar, h.dataset_size, reduce=reduce,
                               impl=h.tc_impl, sampling=h.tc_sampling)
    return (beta - 1.0) * tc + kl, kl


def rec_term(h: SolverHyper, x, recon_x, reduction: str = "sum", beta=None):
    """beta_rec-weighted reconstruction loss (solvers/vae.py:79-87)."""
    if beta is None:
        beta = h.beta_rec
    return beta * ops.reconstruction_loss(x, recon_x, h.recon_loss_type, reduction)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """torch.nn.utils.clip_grad_norm_ semantics (+1e-6); returns
    (clipped grads, pre-clip norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads], norm


def encode(encoder, x, groups: int = 1):
    """Run the encoder: (mu, logvar). Train or eval follows the module's
    mode; groups > 1 gives per-group BatchNorm statistics."""
    return encoder(x, groups)


def decode(decoder, z, groups: int = 1):
    return decoder(z, groups)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

class VAESolver:
    """Shared solver surface: hyperparameters, state construction, the
    step and its finite check. ``build_step`` is overridden by the
    solvers this port carries."""

    kl_kind = "gaussian"
    name = "vae"

    def __init__(
        self,
        *,
        dataset,
        encoder,
        decoder,
        batch_size: int,
        optimizer_e: Callable,
        optimizer_d: Callable,
        recon_loss_type: str = "mse",
        beta_kl: float = 1.0,
        beta_rec: float = 1.0,
        beta_neg: float = 1.0,
        gamma_r: float = 1e-8,
        clip: Optional[float] = None,
        tc_impl: str = "xla",
        tc_sampling: str = "stratified",
        kl_kind: Optional[str] = None,
        fuse_passes: bool = True,
    ):
        self.dataset = dataset
        self.encoder = encoder
        self.decoder = decoder
        self.batch_size = batch_size
        self.optimizer_e = optimizer_e
        self.optimizer_d = optimizer_d
        self.fuse_passes = fuse_passes
        self.hyper = SolverHyper(
            recon_loss_type=recon_loss_type,
            beta_kl=beta_kl,
            beta_rec=beta_rec,
            beta_neg=beta_neg,
            gamma_r=gamma_r,
            scale=1.0 / (encoder.cdim * encoder.image_size**2),
            dataset_size=len(dataset) if dataset is not None else 1,
            kl_kind=kl_kind or self.kl_kind,
            tc_impl=tc_impl,
            tc_sampling=tc_sampling,
            clip=clip,
            zdim=encoder.zdim,
        )
        self._step_fn = self.build_step()

    def build_step(self) -> Callable:
        raise not_ported(f"solver '{self.name}'", "Queue 1 item 6")

    def init_state(self, seed: int) -> TrainState:
        """Fresh optimizer states over the modules' current parameters and
        a noise generator on the parameters' device."""
        device = next(self.encoder.parameters()).device
        return TrainState(
            step=0,
            model=SoftIntroVAE(self.encoder, self.decoder),
            opt_e=self.optimizer_e(self.encoder.parameters()),
            opt_d=self.optimizer_d(self.decoder.parameters()),
            generator=torch.Generator(device=device).manual_seed(seed),
        )

    def train_step(self, state: TrainState, batch: torch.Tensor,
                   noise: Optional[dict] = None):
        """One optimization step, in place. Returns (state, metrics), the
        metrics as 0-d device tensors."""
        return state, self._step_fn(state, batch, noise)

    def check_finite(self, metrics: dict) -> None:
        """Raise RuntimeError on a non-finite loss (reference
        solvers/vae.py:112-113)."""
        for name in ("loss_enc", "loss_dec"):
            if name in metrics and not math.isfinite(float(metrics[name])):
                raise RuntimeError(f"non-finite {name}: {float(metrics[name])}")


def make_solver(name: str, **kwargs) -> VAESolver:
    """Solver factory: 'intro' | 'intro-tc'/'intro_tc' are ported; 'vae'
    and 'tc' raise until ported."""
    from intro_tc_vae_tpu_torch.solvers.intro import IntroSolver
    from intro_tc_vae_tpu_torch.solvers.intro_tc import IntroTCSolver

    solvers = {"intro": IntroSolver, "intro-tc": IntroTCSolver, "intro_tc": IntroTCSolver}
    if name in ("vae", "tc"):
        raise not_ported(f"solver '{name}'", "Queue 1 item 6")
    if name not in solvers:
        raise ValueError(f"Solver '{name}' not supported! "
                         f"(known: {sorted([*solvers, 'vae', 'tc'])})")
    return solvers[name](**kwargs)
