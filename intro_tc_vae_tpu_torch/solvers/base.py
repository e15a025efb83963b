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
* ``graph=True`` (one process on CUDA; ``train.py::graph_step`` says
  when) runs the step as one captured CUDA graph (``solvers/graph.py``),
  the counterpart of the JAX step's ``jax.jit``; otherwise it runs eager.
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
* Tensor parallel (a mesh with a model axis, ``parallel.shard_state``):
  the ranks of a model group step on the same rows, each with its slices
  of the sharded leaves; a sharded gradient is averaged over the data
  group, a replicated one over every rank (``average_grads``), and the
  norms count each sharded gradient's slices once (``global_norm``).
* Observability (JAX solvers/base.py:491-665): with a ``writer`` (rank 0
  only under data parallel), each drain of the metric ring writes every
  step's scalars at its own global step and flushes once; every
  ``test_iter`` steps the image grid and, for factor datasets, the four
  disentanglement metric families run on the step's new state, through
  the eval-mode encoder on the device (a captured graph a batch shape
  where the step is graphed, ``make_eval_encoder``). sklearn, matplotlib
  and the TensorBoard packages are imported where they are used.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from intro_tc_vae_tpu_torch import ops
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE, set_mesh
from intro_tc_vae_tpu_torch.ops import launch_counts
from intro_tc_vae_tpu_torch.parallel import comm_counts
from intro_tc_vae_tpu_torch.parallel.collectives import all_reduce_mean_
from intro_tc_vae_tpu_torch.parallel.mesh import whole_copy
from intro_tc_vae_tpu_torch.solvers import optim
from intro_tc_vae_tpu_torch.solvers.graph import GraphedEval, GraphedStep

# the 7-way key split of the JAX step (solvers/intro.py:81-83) minus the
# carried key: the step's six N(0, I) [B, z] draws, in this order
NOISE_KEYS = ("prior", "real", "rec_e", "fake_e", "rec_d", "fake_d")
# the single-phase step's one draw (JAX solvers/vae.py)
VAE_NOISE_KEYS = ("real",)
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
    # the mesh of a run of several ranks (parallel.make_mesh), else None
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
    of ``solvers/optim.py``. Step counts stay on the parameters' device
    (``optim.place_steps``: torch's classes capturable on CUDA)."""
    key = name.lower()
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}' (known: {sorted(_OPTIMIZERS)})")

    def make(params: Iterable) -> torch.optim.Optimizer:
        return optim.place_steps(_OPTIMIZERS[key](params, lr=lr))

    return make


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


def shards(params: Sequence[torch.Tensor]) -> list:
    """Each parameter's ``parallel.mesh.Shard``, None where it is whole."""
    return [getattr(p, "tp", None) for p in params]


def _mean_over(grads: list, picked: list, group, size: int) -> None:
    """In place in ``grads``: the picked gradients' mean over ``group`` of
    ``size`` ranks (None: every rank), through one flat all-reduce."""
    if size == 1 or not picked:
        return
    flat = torch.cat([grads[i].reshape(-1) for i in picked])
    dist.all_reduce(flat, group=group)
    comm_counts.count("all-reduce", "average_grads", flat)
    flat.div_(size)
    for i, f in zip(picked, flat.split([grads[i].numel() for i in picked])):
        grads[i] = f.view_as(grads[i])


def average_grads(grads: Sequence[torch.Tensor], mesh,
                  shard: Optional[Sequence] = None) -> list:
    """The mean over the data group of each gradient, through one
    all-reduce of a flattened buffer (gradients unchanged in one process).

    With a model axis (``shard``: each parameter's ``Shard`` or None), a
    sharded leaf's gradient is this rank's slice, averaged over the data
    group. A replicated leaf's gradient is computed alike on every rank
    of the model group, but the stock backward (cuDNN's) may sum it in
    another order on each; it is averaged over every rank of the job, the
    data group's mean of M copies, so that replicated leaves stay
    bit-equal across the model axis too."""
    grads = list(grads)
    if mesh is None:
        return grads
    if mesh.model is None:
        _mean_over(grads, list(range(len(grads))), mesh.group, mesh.size)
        return grads
    shard = shard or [None] * len(grads)
    _mean_over(grads, [i for i, s in enumerate(shard) if s is not None], mesh.group, mesh.size)
    _mean_over(grads, [i for i, s in enumerate(shard) if s is None], None,
               mesh.size * mesh.model.size)
    return grads


def average_metrics(metrics: dict, mesh) -> dict:
    """Every metric's mean over the data group, one all-reduce for all
    (the ranks of a model group compute the same values)."""
    if mesh is None or mesh.size == 1:
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
    'tc_full':              MI + beta*TC + dimension-wise KL, the full
        decomposition (``ops.tc_decomposition``; JAX solvers/base.py:106-111)

    Returns (weighted loss, unscaled value for the 'kl_loss_unscaled' tag).
    """
    if beta is None:
        beta = h.beta_kl
    if h.kl_kind == "tc_full":
        parts = ops.tc_decomposition(z, mu, logvar, h.dataset_size, mesh=h.mesh)
        if reduce == "mean":
            parts = [p.mean() for p in parts]
        elif reduce == "sum":
            parts = [p.sum() for p in parts]
        mi, tc, kl = parts
        return mi + beta * tc + kl, mi + tc + kl
    if h.kl_kind not in ("gaussian", "tc"):
        raise ValueError(f"kl_kind={h.kl_kind!r}: expected 'gaussian', 'tc' or 'tc_full'")
    kl = ops.kl_divergence(logvar, mu, reduce=reduce)
    if h.kl_kind == "gaussian":
        return beta * kl, kl
    tc = ops.total_correlation(z, mu, logvar, h.dataset_size, reduce=reduce,
                               impl=h.tc_impl, sampling=h.tc_sampling, mesh=h.mesh)
    return (beta - 1.0) * tc + kl, kl


def tc_decomp_metrics(h: SolverHyper, z, mu, logvar) -> dict:
    """The means of the decomposition's three terms for the
    ``tc_decomp/{mi,tc,kl}`` group (JAX solvers/base.py:123-138), of the
    real batch's KL site; values only, no gradient."""
    with torch.no_grad():
        mi, tc, kl = ops.tc_decomposition(z, mu, logvar, h.dataset_size, mesh=h.mesh)
    return {"tc_decomp/mi": mi.mean(), "tc_decomp/tc": tc.mean(), "tc_decomp/kl": kl.mean()}


def rec_term(h: SolverHyper, x, recon_x, reduction: str = "sum", beta=None):
    """beta_rec-weighted reconstruction loss (solvers/vae.py:79-87)."""
    if beta is None:
        beta = h.beta_rec
    return beta * ops.reconstruction_loss(x, recon_x, h.recon_loss_type, reduction)


def global_norm(tensors: Sequence[torch.Tensor],
                shard: Optional[Sequence] = None) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together. Sharded ones (``shard``)
    are this rank's slices: their squares are summed over the model group
    and counted once, as the norm of the whole tensors is."""
    shard = shard or [None] * len(tensors)
    whole = [t for t, s in zip(tensors, shard) if s is None]
    sq = sum((torch.sum(t * t) for t in whole), torch.zeros((), dtype=tensors[0].dtype,
                                                            device=tensors[0].device))
    sliced = [(t, s) for t, s in zip(tensors, shard) if s is not None]
    if sliced:
        part = sum(torch.sum(t * t) for t, _ in sliced)
        dist.all_reduce(part, group=sliced[0][1].group.group)
        comm_counts.count("all-reduce", "global_norm", part)
        sq = sq + part
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        shard: Optional[Sequence] = None):
    """torch.nn.utils.clip_grad_norm_ semantics (+1e-6); returns
    (clipped grads, pre-clip norm)."""
    norm = global_norm(grads, shard)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads], norm


def apply_grads(optimizer: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step on ``params`` with the given gradients; a phase
    of the step ends here (``launch_counts.mark``)."""
    for p, g in zip(params, grads):
        p.grad = g
    launch_counts.mark()
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
    """Each call's metrics, queued on the device and read on the host
    behind it (JAX solvers/base.py:372-373, :446-481).

    ``push`` stacks a call's metrics into one float32 [K, n] device tensor
    (``push_stacked`` takes one stacked already: the graphed step's), starts
    its copy into a pinned host buffer without blocking, and records a CUDA
    event after it. ``drain(keep_tail)`` reads every entry but the newest
    ``keep_tail``, oldest first, waiting on each entry's event: the train
    loop drains with ``keep_tail=2`` once ``RING_DEPTH + 2`` entries are
    queued, so it reads only calls two or more behind the one just queued,
    which have finished by then in the steady state, and never waits on
    the newest. A drained entry's host buffer goes back to a pool, one
    buffer a ring slot, so a step allocates no pinned memory once the ring
    has filled; no two queued entries share one. On the CPU the copy is the
    tensor itself and there is no event. A call of K steps
    (``scan_steps``) is one entry whose metrics are [K] tensors; ``drain``
    fans it out to K steps."""

    def __init__(self):
        self._entries: list = []
        self._free: dict = {}  # shape -> pinned host buffers not in the ring

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, metrics: dict, step: int) -> None:
        """``metrics``: 0-d tensors of one step, or [K] tensors of K steps,
        the first of which is ``step``."""
        stacked = torch.stack([v.detach().float().reshape(-1) for v in metrics.values()],
                              dim=1)  # [K, n]
        self.push_stacked(tuple(metrics), stacked, step)

    def push_stacked(self, names: tuple, stacked: torch.Tensor, step: int) -> None:
        """``stacked``: float32 [K, n], column i the metric ``names[i]``."""
        event = None
        if stacked.is_cuda:
            free = self._free.get(tuple(stacked.shape))
            host = (free.pop() if free else
                    torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True))
            host.copy_(stacked, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = stacked
        self._entries.append((names, host, event, step))

    def drain(self, keep_tail: int = 0) -> list:
        """[(host metrics dict, step), ...] of the drained entries' steps,
        in step order."""
        n = len(self._entries) - keep_tail
        if n <= 0:
            return []
        drained, self._entries = self._entries[:n], self._entries[n:]
        out = []
        for names, host, event, step in drained:
            if event is not None:
                event.synchronize()
            out.extend((dict(zip(names, row)), step + j)
                       for j, row in enumerate(host.tolist()))
            if event is not None:
                self._free.setdefault(tuple(host.shape), []).append(host)
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
    the encoder's and decoder's BatchNorms get the data group.
    ``scan_steps`` K > 1 takes [K, B, ...] batches and makes K steps a
    call (JAX ``_scan_steps``; a loop here, there is no program to fuse).
    ``remat_passes`` recomputes every encode/decode pass of the intro step
    in its backward (config ``remat: "pass"``); the single-phase step
    ignores it. ``graph`` runs each step as one captured CUDA graph
    (``solvers/graph.py``; one process on CUDA only, ``train.py::
    graph_step``)."""

    kl_kind = "gaussian"
    name = "vae"
    noise_keys = VAE_NOISE_KEYS  # the step's draws, in their order

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
        writer=None,
        test_iter: int = 1000,
        scan_steps: int = 1,
        remat_passes: bool = False,
        graph: bool = False,
    ):
        self.dataset = dataset
        self.encoder = encoder
        self.decoder = decoder
        self.batch_size = batch_size
        self.optimizer_e = optimizer_e
        self.optimizer_d = optimizer_d
        self.fuse_passes = fuse_passes
        self.scan_steps = max(1, int(scan_steps))
        self.remat_passes = remat_passes
        group = mesh if mesh is not None and (mesh.size > 1 or mesh.model is not None) else None
        set_mesh(encoder, group)
        set_mesh(decoder, group)
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
        self.writer = writer
        self.test_iter = test_iter
        # whether this rank's model group holds the writer: under tensor
        # parallelism every rank of that group gathers the whole model for
        # the writer's eval passes (``eval_state``)
        self.heavy_writes = writer is not None
        if group is not None and group.model is not None:
            flags = [None] * group.model.size
            dist.all_gather_object(flags, self.heavy_writes, group=group.model.group)
            self.heavy_writes = any(flags)
        self.latent_generator = None
        try:
            if dataset is not None and dataset.latent_indices is not None:
                from intro_tc_vae_tpu_torch.evaluation.generator import LatentGenerator

                self.latent_generator = LatentGenerator(dataset)
        except (NotImplementedError, AttributeError):
            pass  # plain (non-factor) dataset: no disentanglement metrics
        self._step_fn = self.build_step()
        self.graphed = (GraphedStep(self._step_fn, self.noise_keys, encoder.zdim)
                        if graph else None)
        # every step's metrics, read on the host behind the device
        self.metric_ring = MetricRing()
        # the eval-mode encoder's graphs (``make_eval_encoder``), where the step is graphed
        self._eval_encode: Optional[GraphedEval] = None

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

    def train_step(self, state: TrainState, batch: torch.Tensor, noise=None):
        """One optimization step, or ``scan_steps`` K of them, in place.
        Returns (state, metrics), the metrics as 0-d device tensors, [K]
        ones for K steps (their mean over the ranks under a data group),
        and queues them on the metric ring. ``batch`` is this rank's rows,
        [B, ...] or [K, B, ...], float32 in [0, 1] or uint8 (normalized
        here on the device, ``normalize_input``); ``noise``, when given,
        holds the global batch's draws, a list of K such dicts for K
        steps. With a writer, the image grid and the disentanglement scores
        run on the new state and the last batch when the call's first
        global iteration (JAX's ``cur_iter``: the steps before it,
        ``state.step`` on entry, resumed runs included) is a multiple of
        ``test_iter`` (JAX solvers/base.py:425-444); they run eagerly on the
        live modules, between replays when the step is graphed, where a
        call of K steps is K replays."""
        cur_iter = state.step
        k = self.scan_steps
        batches = batch.unbind(0) if k > 1 else (batch,)
        noises = noise if k > 1 and noise is not None else [noise] * k
        if self.graphed is not None:
            # K replays; each row copied out before the next overwrites it
            stacked = None
            for j, (b, n) in enumerate(zip(batches, noises)):
                names, row = self.graphed(state, b, n)
                if stacked is None:
                    stacked = torch.empty((k, row.numel()), dtype=row.dtype,
                                          device=row.device)
                stacked[j].copy_(row)
            self.metric_ring.push_stacked(names, stacked, cur_iter + 1)
            metrics = {name: stacked[:, i] if k > 1 else stacked[0, i]
                       for i, name in enumerate(names)}
        else:
            steps = [self._step_fn(state, normalize_input(b), n)
                     for b, n in zip(batches, noises)]
            metrics = steps[0] if k == 1 else {
                name: torch.stack([m[name] for m in steps]) for name in steps[0]}
            metrics = average_metrics(metrics, self.hyper.mesh)
            self.metric_ring.push(metrics, cur_iter + 1)
        if self.heavy_writes and cur_iter % self.test_iter == 0:
            self._write_heavy_metrics(state, batches[-1], cur_iter)
        return state, metrics

    def eval_state(self, state: TrainState) -> TrainState:
        """``state`` with a model the writer's eval passes can run alone:
        under tensor parallelism a whole copy, which every rank of the
        model group gathers (``parallel.mesh.whole_copy``); else
        ``state`` itself."""
        model = whole_copy(state.model)
        return state if model is state.model else dataclasses.replace(state, model=model)

    def drain_metrics(self, keep_tail: int = 0) -> list:
        """The ring's entries but the newest ``keep_tail`` on the host:
        ``[(metrics dict, step), ...]`` in step order (JAX
        ``drain_metrics``). With a writer, each entry's scalars are written
        at its global iteration, ``step - 1`` (the ring records the step
        count after the step; JAX writes at the count before it), and the
        writer is flushed once per drain."""
        out = self.metric_ring.drain(keep_tail)
        if self.writer is not None and out:
            for metrics, step in out:
                self._write_scalar_metrics(metrics, step - 1)
            self.writer.flush()
        return out

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

    # -- observability ----------------------------------------------------

    def _write_scalar_metrics(self, metrics: dict, cur_iter: int) -> None:
        """Write one step's (host-side) scalar dict to TensorBoard (JAX
        solvers/base.py:491-513)."""
        losses = dict(r_loss=float(metrics["loss_rec"]), kl_loss=float(metrics["loss_kl"]))
        if "expelbo_f" in metrics:
            losses["expelbo_f"] = float(metrics["expelbo_f"])
        self.write_scalars(cur_iter, losses)
        for tag in ("kl_loss_unscaled", "r_loss_unscaled", "lossE", "lossD",
                    "diff_kl", "fc_grad_norm"):
            if tag in metrics:
                self.writer.add_scalar(tag, float(metrics[tag]), global_step=cur_iter)
        if "tc_decomp/mi" in metrics:  # kl_kind 'tc_full'
            self.writer.add_scalars(
                "tc_decomp", {k: float(metrics[f"tc_decomp/{k}"]) for k in ("mi", "tc", "kl")},
                global_step=cur_iter)
        if self.hyper.clip and "total_norm" in metrics:
            self.writer.add_scalar("total_norm", float(metrics["total_norm"]),
                                   global_step=cur_iter)

    def _write_heavy_metrics(self, state: TrainState, batch: torch.Tensor,
                             cur_iter: int) -> None:
        state = self.eval_state(state)
        if self.writer is None:
            return
        self._write_images_helper(state, batch, cur_iter)
        self.write_disentanglemnt_scores(state, cur_iter)

    def write_scalars(self, cur_iter: int, losses: dict, **kwargs) -> None:
        if self.writer is not None:
            self.writer.add_scalars("losses", losses, global_step=cur_iter)
            for name, value in kwargs.items():
                self.writer.add_scalar(name, value, global_step=cur_iter)

    def _write_images_helper(self, state: TrainState, batch: torch.Tensor, cur_iter: int,
                             noise: Optional[torch.Tensor] = None) -> None:
        """Prior samples of ``noise`` (drawn from a generator seeded with
        ``cur_iter`` unless given; JAX folds ``cur_iter`` into key 0), then
        ``write_images``."""
        if self.writer is None or cur_iter % self.test_iter != 0:
            return
        if noise is None:
            gen = torch.Generator(device=batch.device).manual_seed(cur_iter)
            noise = torch.randn((batch.shape[0], self.hyper.zdim), generator=gen,
                                device=batch.device)
        fake = decode(state.model.decoder, noise, train=False)
        self.write_images(state, batch, fake, cur_iter)

    def write_images(self, state: TrainState, batch: torch.Tensor,
                     fake_batch: torch.Tensor, cur_iter: int) -> None:
        """Real / deterministic-reconstruction / sampled grids, 16 each, as
        one NCHW grid tagged "reconstructions" (reference
        solvers/vae.py:147-163). Every rank calls it (``eval_state``)."""
        if not self.heavy_writes or cur_iter % self.test_iter != 0:
            return
        state = self.eval_state(state)
        if self.writer is None:
            return
        batch = normalize_input(batch)  # the uint8 paths: normalize here
        mu, _ = encode(state.model.encoder, batch, train=False)
        rec_det = decode(state.model.decoder, mu, train=False)
        n = min(batch.shape[0], 16)
        grid = torch.cat([batch[:n].float(), rec_det[:n], fake_batch[:n].float()])
        self.writer.add_images("reconstructions", grid.cpu().numpy(), global_step=cur_iter)

    def write_disentanglemnt_scores(self, state: TrainState, cur_iter: int,
                                    num_samples: int = 10000) -> None:
        """Four disentanglement metric families (reference vae.py:188-213).

        Name spelled as in the reference API (quirk Q9). Each family runs in
        its own ``try``: a failure (a degenerate draw, or sklearn absent on
        this host) is printed and the others still run.
        """
        if (
            self.writer is None
            or self.latent_generator is None
            or cur_iter % self.test_iter != 0
        ):
            return
        from intro_tc_vae_tpu_torch.evaluation import metrics as em

        if len(self.dataset) < num_samples:
            num_samples = len(self.dataset) // 2
        kwargs = dict(
            latent_generator=self.latent_generator,
            encode_fn=self.make_eval_encoder(state),
            num_samples=num_samples,
            batch_size=self.batch_size,
        )
        for write in (em.write_bvae_score, em.write_dci_score,
                      em.write_mig_score, em.write_mod_expl_score):
            try:
                write(self.writer, cur_iter, **kwargs)
            except Exception as e:
                print(f"disentanglement metric {write.__name__} failed: {e!r}")

    def make_eval_encoder(self, state: TrainState, eager: bool = False) -> Callable:
        """Eval-mode encode on the encoder's device: NHWC numpy images ->
        (mu, logvar) numpy (JAX solvers/base.py:593-612). Where the step is
        graphed (``self.graphed``, as ``train.py::graph_step`` decides), the
        pass runs through the solver's ``GraphedEval`` of this encoder, a
        graph for each batch shape from the step's graph factory (the
        counterpart of the JAX encoder's ``jax.jit``), kept across calls
        as JAX keeps its jitted encoder; otherwise, or with ``eager``, it
        runs eager."""
        encoder = state.model.encoder
        device = next(encoder.parameters()).device

        def eval_pass(x):
            return encode(encoder, normalize_input(x), train=False)

        run = eval_pass
        if self.graphed is not None and not eager:
            if self._eval_encode is None or self._eval_encode.modules[0] is not encoder:
                self._eval_encode = GraphedEval(eval_pass, (encoder,),
                                                graph_factory=self.graphed.graph_factory)
            run = self._eval_encode

        def encode_fn(x):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))
            mu, logvar = run(x.to(device))
            return mu.cpu().numpy(), logvar.cpu().numpy()

        return encode_fn

    def write_gradient_flow(self, state: TrainState, batch: torch.Tensor,
                            cur_iter: int) -> None:
        """Per-layer |grad| mean/max bar chart (reference vae.py:215-254) of
        the ELBO's gradient on ``batch``; nothing in the loop calls it. The
        BatchNorm statistics the train-mode passes update are restored."""
        if self.writer is None or cur_iter % self.test_iter != 0:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        h, model = self.hyper, state.model
        batch = normalize_input(batch)
        buffers = {k: v.clone() for k, v in model.named_buffers()}
        gen = torch.Generator(device=batch.device).manual_seed(12345 + cur_iter)
        try:
            mu, logvar = encode(model.encoder, batch)
            eps = torch.randn(mu.shape, generator=gen, device=mu.device)
            z = ops.reparameterize(mu, logvar, eps)
            rec = decode(model.decoder, z)
            l_kl, _ = kl_term(h, z, mu, logvar)
            loss = h.scale * (rec_term(h, batch, rec, reduction="mean") + l_kl)
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named])
        finally:
            with torch.no_grad():
                for k, v in model.named_buffers():
                    v.copy_(buffers[k])
        layers, ave, mx = [], [], []
        for (name, _), g in zip(named, grads):
            if name.endswith("bias"):
                continue
            layers.append(name)
            g = g.detach().abs().float()
            ave.append(float(g.mean()))
            mx.append(float(g.max()))
        fig, ax = plt.subplots(figsize=(12, 4))
        ax.bar(np.arange(len(mx)), mx, alpha=0.3, lw=1, color="c", label="max-gradient")
        ax.bar(np.arange(len(ave)), ave, alpha=0.3, lw=1, color="b", label="mean-gradient")
        ax.set_xticks(range(len(layers)))
        ax.set_xticklabels(layers, rotation="vertical", fontsize=4)
        ax.set_ylim(bottom=-0.001, top=0.02)
        ax.set_xlabel("Layers")
        ax.set_ylabel("average gradient")
        ax.set_title("Gradient flow")
        ax.legend()
        fig.tight_layout()
        self.writer.add_figure("gradient_flow", fig, global_step=cur_iter)
        plt.close(fig)


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
