"""Solver core: hyperparameters, train state, optimizers, loss terms and a
lean ``VAESolver``.

Counterpart of ``intro_tc_vae_tpu/solvers/base.py``. Differences that
follow from PyTorch rather than from the model:

* Parameters and BatchNorm statistics live in the modules and are updated
  in place; ``TrainState`` holds the modules, the two optimizers (one per
  network, reference train.py:143-144) and the noise generator.
* ``make_optimizer`` returns a factory over parameters — the counterpart
  of an optax transform, which holds no state until ``init`` — with
  optax's semantics and defaults (``solvers/optim.py``).
* Each step's metrics go on a ring (``MetricRing``) that the train loop
  reads on the host behind the card, as the JAX package's
  ``drain_metrics`` does.
* Noise comes from an explicit ``torch.Generator`` on the device, or is
  passed in (parity tests hand both packages the same draws).
* Data parallel (``mesh``, a ``parallel.DataGroup`` of several ranks):
  each rank steps on its rows of the global batch. The counterparts of
  the psums GSPMD inserts are explicit: the TC and BatchNorm reduce over
  the global batch themselves, each optimizer's gradients are averaged
  over the ranks with one all-reduce before the clip and the update, and
  the step's metrics with one all-reduce, so every rank sees the same
  values and ``check_finite`` raises on all of them together. No
  ``DistributedDataParallel``: the intro step differentiates one network
  with ``torch.autograd.grad`` while the other is ``frozen``, which DDP's
  ``.backward()`` hooks do not follow.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from intro_tc_vae_tpu_torch import not_ported, ops
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE, set_data_group
from intro_tc_vae_tpu_torch.parallel.collectives import all_reduce_mean_
from intro_tc_vae_tpu_torch.solvers import optim

# the 7-way key split of the JAX step (solvers/intro.py:81-83) minus the
# carried key: the step's six N(0, I) [B, z] draws, in this order
NOISE_KEYS = ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")
# steps queued on the metric ring before the loop reads it (JAX ring_depth)
RING_DEPTH = 8

# optax's defaults, which are not torch's where both have the optimizer
_OPTIMIZERS = {
    "adam": functools.partial(torch.optim.Adam, betas=(0.9, 0.999), eps=1e-8),
    "adamw": functools.partial(torch.optim.AdamW, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=1e-4),
    "adagrad": optim.Adagrad,
    "adadelta": functools.partial(torch.optim.Adadelta, rho=0.9, eps=1e-6),
    "sgd": functools.partial(torch.optim.SGD, momentum=0.0),
    "rmsprop": optim.RMSprop,
    "lamb": optim.Lamb,
    "lion": optim.Lion,
}


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
    tc_impl: str = "xla"            # 'xla' | 'blockwise' | 'pallas' (the CUDA kernels)
    tc_sampling: str = "stratified"
    clip: Optional[float] = None
    zdim: int = 32
    # the data group of a data-parallel run (several ranks), else None
    mesh: Any = dataclasses.field(default=None, compare=False)


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
    # the eval-mode decode of fresh noise the train loop makes after its
    # last epoch (JAX train.py:317-331), [B, C, H, W] in [0, 1]
    samples: Optional[torch.Tensor] = None


def make_optimizer(name: str, lr: float) -> Callable[[Iterable], torch.optim.Optimizer]:
    """Optimizer factory by name (case-insensitive): optax's transform of
    that name with optax's defaults (JAX solvers/base.py:68-86), as a
    ``torch.optim`` class where one computes the same update, else a class
    of ``solvers/optim.py``."""
    key = name.lower()
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}' (known: {sorted(_OPTIMIZERS)})")
    return functools.partial(_OPTIMIZERS[key], lr=lr)


def draw_noise(generator: torch.Generator, batch: int, zdim: int,
               device: torch.device, keys: Sequence[str] = NOISE_KEYS) -> dict:
    return {k: torch.randn((batch, zdim), generator=generator, device=device)
            for k in keys}


def step_noise(h: "SolverHyper", generator: torch.Generator, noise: Optional[dict],
               b_local: int, device: torch.device,
               keys: Sequence[str] = NOISE_KEYS) -> dict:
    """This rank's rows of the step's noise. The noise is drawn (unless
    given) at the global batch from the generator every rank seeds alike,
    so one process and R ranks use the same draws for the same samples."""
    size, rank = (1, 0) if h.mesh is None else (h.mesh.size, h.mesh.rank)
    if noise is None:
        noise = draw_noise(generator, b_local * size, h.zdim, device, keys)
    rows = slice(rank * b_local, (rank + 1) * b_local)
    return {k: noise[k][rows] for k in keys}


def average_grads(grads: Sequence[torch.Tensor], mesh) -> list:
    """The mean over the ranks of ``mesh`` of each gradient, through one
    all-reduce of a flattened buffer (gradients unchanged without one)."""
    if mesh is None:
        return list(grads)
    flat = all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads]), mesh)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def average_metrics(metrics: dict, mesh) -> dict:
    """Every metric's mean over the ranks, one all-reduce for all."""
    if mesh is None:
        return metrics
    flat = all_reduce_mean_(torch.stack([v.double() for v in metrics.values()]), mesh)
    return {k: f.to(v.dtype) for (k, v), f in zip(metrics.items(), flat)}


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
                               impl=h.tc_impl, sampling=h.tc_sampling, mesh=h.mesh)
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


def apply_grads(optimizer: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step on ``params`` with the given gradients."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """Run the block with ``module``'s parameters not requiring grad.

    Values do not change. Gradients still flow through the module's
    activations, but no weight gradient of it is computed: autograd skips
    them for stock ops, and the conv kernels' ``torch.autograd.Function``
    reads ``needs_input_grad``, which is fixed when the forward runs. In
    JAX the unused gradients are dead code that XLA drops."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@contextlib.contextmanager
def eval_mode(module: torch.nn.Module):
    """Run the block with ``module`` in eval mode under ``no_grad``, then
    give it back the mode it had, however the block ends."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        module.train(was_training)


def encode(encoder, x, groups: int = 1, train: bool = True):
    """Run the encoder: (mu, logvar). ``train`` True follows the module's
    mode (the step's passes; groups > 1 gives per-group BatchNorm
    statistics); False is an eval-mode pass under ``no_grad`` with the
    running statistics, and the module's mode is restored after it (JAX
    ``encode(..., train=False)``, solvers/base.py:163)."""
    if train:
        return encoder(x, groups)
    with eval_mode(encoder):
        return encoder(x)


def decode(decoder, z, groups: int = 1, train: bool = True):
    """Run the decoder; ``train`` as in ``encode``."""
    if train:
        return decoder(z, groups)
    with eval_mode(decoder):
        return decoder(z)


# x / 255 for every uint8 value, computed on the host with numpy's IEEE
# divide (JAX solvers/base.py:186-198). A divide by a scalar on the card is
# a multiply by its reciprocal in PyTorch's CUDA kernel, as in XLA, which
# is 1 ULP off the host's quotient for some values; a lookup in this
# 256-entry table gives the host's bits exactly.
_U8_UNIT = np.arange(256, dtype=np.float32) / 255.0


@functools.lru_cache(maxsize=None)
def _u8_unit_table(device: torch.device) -> torch.Tensor:
    """The table on ``device``, copied there once (a copy from pageable
    memory at every step would wait for the device's queue)."""
    return torch.from_numpy(_U8_UNIT).to(device)


def u8_to_unit_f32(batch: torch.Tensor) -> torch.Tensor:
    """uint8 image batch -> float32 in [0, 1] on its device, bit-equal to
    the host pipeline's ``/ 255`` (see ``_U8_UNIT``)."""
    return _u8_unit_table(batch.device)[batch.long()]


def normalize_input(batch: torch.Tensor) -> torch.Tensor:
    """A uint8 batch (the loader's uint8 and cache paths) as float32 in
    [0, 1]; any other batch as it is (JAX ``_normalize_input``)."""
    return u8_to_unit_f32(batch) if batch.dtype == torch.uint8 else batch


def unit_f32_to_u8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] float image -> uint8 on the device, bit-equal to the host
    export ``(np.clip(x, 0, 1) * 255).astype(np.uint8)`` (JAX
    solvers/base.py:201-212). numpy's cast truncates; the floor makes that
    explicit, and clip, multiply and floor are each one exact IEEE float32
    operation on either side."""
    x = torch.clamp(img.float(), 0.0, 1.0) * 255.0
    return torch.floor(x).to(torch.uint8)


class MetricRing:
    """Each step's metrics, queued on the device and read on the host
    behind it (JAX solvers/base.py:372-373, :446-481).

    ``push`` stacks a step's metrics into one float32 device tensor, starts
    its copy into a pinned host buffer without blocking, and records a CUDA
    event after it. ``drain(keep_tail)`` reads every entry but the newest
    ``keep_tail``, oldest first, waiting on each entry's event: the train
    loop drains with ``keep_tail=2`` once ``RING_DEPTH + 2`` entries are
    queued, so it reads only steps two or more behind the one just queued,
    which have finished by then in the steady state, and never waits on
    the newest. On the CPU the copy is the tensor itself and there is no
    event."""

    def __init__(self):
        self._entries: list = []

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, metrics: dict, step: int) -> None:
        stacked = torch.stack([v.detach().float() for v in metrics.values()])
        event = None
        if stacked.is_cuda:
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = stacked
        self._entries.append((tuple(metrics), host, event, step))

    def drain(self, keep_tail: int = 0) -> list:
        """[(host metrics dict, step), ...] of the drained entries, in step order."""
        n = len(self._entries) - keep_tail
        if n <= 0:
            return []
        drained, self._entries = self._entries[:n], self._entries[n:]
        out = []
        for names, host, event, step in drained:
            if event is not None:
                event.synchronize()
            out.append((dict(zip(names, host.tolist())), step))
        return out


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

class VAESolver:
    """The 'vae' solver and the shared solver surface: hyperparameters,
    state construction, the step and its finite check. ``build_step`` is
    the single-phase ELBO step (solvers/vae.py); the intro solvers
    override it. ``mesh`` (``parallel.make_mesh``) makes the step
    data-parallel: every rank passes its rows of the global batch, and
    the encoder's and decoder's BatchNorms get the data group."""

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
        mesh=None,
    ):
        self.dataset = dataset
        self.encoder = encoder
        self.decoder = decoder
        self.batch_size = batch_size
        self.optimizer_e = optimizer_e
        self.optimizer_d = optimizer_d
        self.fuse_passes = fuse_passes
        group = mesh if mesh is not None and mesh.size > 1 else None
        set_data_group(encoder, group)
        set_data_group(decoder, group)
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
            mesh=group,
        )
        self._step_fn = self.build_step()
        # every step's metrics, read on the host behind the device
        self.metric_ring = MetricRing()

    def build_step(self) -> Callable:
        from intro_tc_vae_tpu_torch.solvers.vae import build_vae_step

        return build_vae_step(self.hyper, self.encoder, self.decoder)

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
        metrics as 0-d device tensors (their mean over the ranks under a
        data group), and queues them on the metric ring. ``batch`` is this
        rank's rows, float32 in [0, 1] or uint8 (normalized here on the
        device, ``normalize_input``); ``noise``, when given, holds the
        global batch's draws."""
        batch = normalize_input(batch)
        metrics = average_metrics(self._step_fn(state, batch, noise), self.hyper.mesh)
        self.metric_ring.push(metrics, state.step)
        return state, metrics

    def drain_metrics(self, keep_tail: int = 0) -> list:
        """The ring's entries but the newest ``keep_tail`` on the host:
        ``[(metrics dict, step), ...]`` in step order (JAX
        ``drain_metrics``)."""
        return self.metric_ring.drain(keep_tail)

    def flush_writes(self) -> list:
        """Drain the metric ring completely; returns what ``drain_metrics``
        returns."""
        return self.drain_metrics(0)

    def check_finite(self, metrics: dict) -> None:
        """Raise RuntimeError on a non-finite loss (reference
        solvers/vae.py:112-113)."""
        for name in ("loss_enc", "loss_dec"):
            if name in metrics and not math.isfinite(float(metrics[name])):
                raise RuntimeError(f"non-finite {name}: {float(metrics[name])}")


def make_solver(name: str, **kwargs) -> VAESolver:
    """Solver factory: 'vae' | 'tc' | 'intro' | 'intro-tc'/'intro_tc'
    (JAX solvers/base.py:669)."""
    from intro_tc_vae_tpu_torch.solvers.intro import IntroSolver
    from intro_tc_vae_tpu_torch.solvers.intro_tc import IntroTCSolver
    from intro_tc_vae_tpu_torch.solvers.tc import TCSolver

    solvers = {
        "vae": VAESolver,
        "tc": TCSolver,
        "intro": IntroSolver,
        "intro-tc": IntroTCSolver,
        "intro_tc": IntroTCSolver,
    }
    if name not in solvers:
        raise ValueError(f"Solver '{name}' not supported! (known: {sorted(solvers)})")
    return solvers[name](**kwargs)
