"""Training entry: dataset/model/solver wiring + epoch loop.

Counterpart of ``intro_tc_vae_tpu/train.py::train_soft_intro_vae``:
seeding, dataset, model, two optimizers, loader, solver, resume, and the
epoch loop (JAX ``train.py:220-356``): periodic and final checkpoints
(``utils/checkpoint.py``), the metric ring drained two steps behind the
device (``solvers/base.py::MetricRing``), ``profile`` and
``anomaly_detection``, the eval-mode decode of fresh noise after the last
epoch, and a ``finally`` that drains the ring and waits for any save in
flight however the loop ends. Runs on ``cuda:0`` unless the caller
passes another device; there is no CPU fallback (the tests pass
``torch.device("cpu")`` explicitly).

``resume`` takes a checkpoint path, or ``"auto"`` for the newest
checkpoint of this run's hyperparameters (``Config.fingerprint()``) in
``checkpoint_dir``. It restores parameters, BatchNorm statistics, both
optimizer states and the step, from which the step count continues; the
epoch restarts at the saved one. The noise generator and the loader's
order start again from the seed, as in the JAX package.

Data parallel (JAX ``train.py:90-138``, ``:219``): started as R
processes (``parallel/distributed.py`` says how), each rank trains on
its card, ``cuda:(LOCAL_RANK % device_count)``, with its rows of every
global batch of ``batch_size``; rank 0's weights are broadcast to all,
only rank 0 prints and writes checkpoints, and every rank loads them.
``data_parallel`` is the *total* number of ranks, as in JAX, and must be
0 or the number of processes: a process cannot be left out of the mesh,
so where JAX shrinks the mesh to a size that divides the batch, the port
raises.

Tensor parallel (``model_parallel`` M > 1; JAX ``train.py:115-138``,
``:219``): the ranks form a ('data', 'model') grid of R / M data indices
by M model indices (``parallel.make_mesh``); R must divide by M and the
batch by R / M, with JAX's messages. The ranks of one data index train on
the same rows, and the wide conv kernels, their BatchNorm parameters and
statistics, the two fc heads and their optimizer moments are cut over
them (``parallel.shard_state`` on the replicated state, JAX's
``param_spec`` rules); checkpoints hold whole tensors either way.

Data (JAX ``train.py:165-186``): the loader stages ``num_workers``
batches ahead on a thread, transfers them as uint8 where the dataset
stores its images exactly so (``transfer_dtype``), or keeps the whole
dataset on the card and gathers there (``device_cache``,
``data/loader.py``); a uint8 batch is normalized on the device before the
range check and the step see it.

``precision: "fp32"`` means fp32 on the card too: for such a run both
TF32 switches are off (PyTorch lets cuDNN compute fp32 convolutions in TF32
by default), as the JAX counterpart computes in true fp32 and as the
``conv_impl: pallas`` kernels do; they are restored when the run ends.

TensorBoard (``use_tensorboard``; JAX ``train.py:105-113``, ``:310-311``,
``:356-377``): rank 0 makes the writer (``utils/writer.py``) in
``log_dir + run_comment()``; each drain of the metric ring writes every
step's scalars at its global iteration, every ``test_iter`` iterations
the image grid and, for factor datasets, the disentanglement scores are
written, each epoch its img/s (``perf/images_per_sec``), and at the end
the hparams table with the last epoch's mean losses. A resumed run
continues the iteration count.

Solver options (JAX ``train.py:70-77``, ``:139-214``): ``scan_steps`` K
makes each loader item K global batches, [K, B, ...], and each
``train_step`` call K steps; the iteration count goes on by K a call, an
epoch's img/s counts K·B images a call, and the final sample grid shows
the last of the K batches. ``remat: true | "block"`` recomputes each
encoder and decoder block in the backward, ``"pass"`` every encode and
decode pass of the intro step; with the single-phase ``vae`` and ``tc``
solvers, which have no passes, ``"pass"`` falls back to ``"block"`` with
JAX's message.

The step (JAX ``train.py:219``, ``jax.jit``): where the run is one process
on CUDA, each step runs as one captured CUDA graph
(``solvers/graph.py``), the counterpart of the JAX step's one compiled
program. ``graph_step`` decides from the configuration alone: data or
tensor parallel runs (their gloo collectives cannot be captured),
``anomaly_detection`` (its checks wait on the host), ``profile`` (its
trace attributes the step's work by operation, which a replay hides) and
the CPU run eager. ``graph`` (an argument of ``setup``, ``build_solver``
and ``train_soft_intro_vae``, not a config key) forces eager with False;
True where the rule says eager raises.

Model options (JAX ``train.py:146-159``): ``tile_rows`` > 0 strip-tiles
every conv with kernel > 1 (-1, auto, resolves to 0: ``resolve_tile_rows``),
and takes the 3x3 convs off the conv kernels as in JAX;
``pack_predict`` > 1 computes the decoder's predict conv output-packed
(auto, -1, stays off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from intro_tc_vae_tpu_torch.config import Config, validate_config
from intro_tc_vae_tpu_torch.data import DeviceLoader, load_dataset
from intro_tc_vae_tpu_torch.models import (
    Decoder,
    Encoder,
    num_params,
    resolve_conv_impl,
    resolve_tile_rows,
)
from intro_tc_vae_tpu_torch.models.vae import SoftIntroVAE
from intro_tc_vae_tpu_torch.parallel import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicate_state,
    shard_state,
)
from intro_tc_vae_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
    rank_device,
)
from intro_tc_vae_tpu_torch.solvers import TrainState, make_optimizer, make_solver
from intro_tc_vae_tpu_torch.solvers.base import (
    RING_DEPTH,
    VAESolver,
    decode,
    normalize_input,
)
from intro_tc_vae_tpu_torch.utils.checkpoint import (
    finalize_checkpoints,
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from intro_tc_vae_tpu_torch.utils.lossdict import LossDict
from intro_tc_vae_tpu_torch.utils.nan import anomaly_detection, check_unit_range
from intro_tc_vae_tpu_torch.utils import tracing
from intro_tc_vae_tpu_torch.utils.profiling import profile_trace
from intro_tc_vae_tpu_torch.utils.writer import SingletonWriter, make_writer

PRINT_EVERY = 5     # steps between progress lines
# steps left out of the final img/s figure: a graphed step's eager warm-up
# (solvers/graph.py) and the step that captures it
WARMUP_STEPS = 4
PROFILE_STEPS = 50  # profile: true stops after the step at this iteration


def resolve_remat(config: Config, say: Callable = print) -> Config:
    """``remat: "pass"`` has no passes to recompute in the single-phase
    ``vae`` and ``tc`` steps: per-block recompute instead, said as JAX says
    it (JAX train.py:70-77)."""
    if config.remat == "pass" and config.solver in ("vae", "tc"):
        say(f"remat='pass' has no pass structure in the '{config.solver}' "
            "solver; falling back to per-block rematerialization")
        return dataclasses.replace(config, remat="block")
    return config


def data_axis_size(config: Config, world: int) -> int:
    """The number of ranks the batch splits over (JAX train.py:115-138):
    ``data_parallel`` (or every process, for 0) is the total number of
    ranks, which must divide by ``model_parallel``; the batch splits over
    the data axis, total / model_parallel."""
    mp = max(1, config.model_parallel)
    n = config.data_parallel or world
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    if n != world:
        raise ValueError(
            f"data_parallel={config.data_parallel} but {world} process(es) run: "
            f"start {n} ranks (torchrun --nproc_per_node {n}, or RANK/WORLD_SIZE/"
            f"LOCAL_RANK with ITCVAE_COORDINATOR_ADDRESS), or set data_parallel "
            f"to 0 or {world}"
        )
    if config.batch_size % (n // mp) != 0:
        raise ValueError(
            f"batch_size {config.batch_size} not divisible by the data-axis "
            f"size {n // mp} (data_parallel={config.data_parallel} "
            f"total devices / model_parallel={mp})"
        )
    return n // mp


def _quiet(*args, **kwargs) -> None:
    pass


@contextlib.contextmanager
def true_fp32(precision: str):
    """For ``precision`` "fp32": cuDNN convolutions and matrix products in
    fp32 proper, not TF32 (10 mantissa bits), until the block ends, however
    it ends. A bf16 run leaves the switches as it found them."""
    if precision != "fp32":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def graph_step(config: Config, device: torch.device, mesh,
               graph: Optional[bool] = None) -> bool:
    """Whether a run's step is one captured CUDA graph: on CUDA, in one
    process (no data or model axis), without ``anomaly_detection`` or
    ``profile``. ``graph`` None follows that rule, False forces eager, and
    True raises where the rule says eager."""
    reasons = [why for bad, why in (
        (device.type != "cuda", f"the run is on {device}"),
        (mesh is not None and (mesh.size > 1 or mesh.model is not None),
         "the run is data or tensor parallel (gloo collectives cannot be captured)"),
        (config.anomaly_detection, "anomaly_detection checks on the host"),
        (config.profile, "profile traces the eager step's operations"),
    ) if bad]
    if graph and reasons:
        raise ValueError(f"graph=True, but the step runs eager: {'; '.join(reasons)}")
    return not reasons if graph is None else bool(graph)


def train_soft_intro_vae(config: Config, device: Optional[torch.device] = None,
                         graph: Optional[bool] = None) -> TrainState:
    """Run one training job from a Config; returns the final TrainState,
    whose ``history`` holds one record per step (losses, epoch, step and
    seconds) and ``samples`` the decode after the last epoch. ``graph``:
    ``graph_step``'s."""
    with true_fp32(config.precision):
        return _train(config, device, graph)


@dataclasses.dataclass
class Run:
    """What the loop works on, as ``setup`` builds it."""

    seed: int
    device: torch.device
    mesh: object
    loader: DeviceLoader
    solver: VAESolver
    state: TrainState
    say: Callable = print  # print on rank 0, nothing on the others
    writer: object = None  # TensorBoard's, on rank 0 with use_tensorboard

    @property
    def group(self):
        """The mesh for the checkpoints (None in one process)."""
        return self.mesh if self.mesh.size > 1 or self.mesh.model is not None else None


def setup(config: Config, device: Optional[torch.device] = None,
          graph: Optional[bool] = None) -> Run:
    """Seeding, dataset, model, optimizers, loader, solver and a fresh
    state, as a run starts (reference train.py:38-192). ``graph``:
    ``graph_step``'s."""
    validate_config(config)
    distributed = initialize_distributed()
    n_data = data_axis_size(config, process_count())
    mp = max(1, config.model_parallel)
    device = rank_device() if device is None else torch.device(device)
    mesh = make_mesh(n_data * mp, model_parallel=mp, device=device)
    rank0 = process_index() == 0
    say = print if rank0 else _quiet
    config = resolve_remat(config, say)

    # ----- seeding (reference train.py:38-44) -----
    seed = config.seed if config.seed != -1 else int(time.time()) % (2**31)
    if distributed:  # one seed for all ranks: the noise generators must agree
        box = [seed]
        torch.distributed.broadcast_object_list(box, src=0)
        seed = box[0]
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the modules' default init draws from it
    if config.seed != -1:
        say("random seed: ", seed)

    # ----- data + model -----
    train_set, image_size, channels, ch = load_dataset(
        config.dataset, data_root=config.data_root
    )
    model_kwargs = dict(
        arch=config.arch, cdim=ch, zdim=config.z_dim, channels=tuple(channels),
        image_size=image_size,
        compute_dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
        conv_impl=resolve_conv_impl(config.conv_impl),
        tile_rows=resolve_tile_rows(config.tile_rows, image_size),
        remat=config.remat in (True, "block"),
    )
    # ----- writer (reference train.py:94-103): rank 0 only -----
    writer = (make_writer(comment=config.run_comment(), log_dir=config.log_dir)
              if config.use_tensorboard and rank0 else None)
    SingletonWriter().writer = writer
    SingletonWriter().cur_iter = 0
    SingletonWriter().test_iter = max(1, len(train_set) // config.batch_size)

    encoder = Encoder(**model_kwargs).to(device)
    # pack_predict auto (-1) stays off, as in JAX, until the card has
    # measured the packed predict conv in context (ROADMAP Queue 5 item 2)
    decoder = Decoder(**model_kwargs, pack_predict=max(0, config.pack_predict)).to(device)
    say(f"{num_params(SoftIntroVAE(encoder, decoder)):,} Parameters")

    # ----- loader (JAX train.py:165-186) -----
    loader = DeviceLoader(train_set, batch_size=config.batch_size, device=device,
                          shuffle=True, seed=seed,
                          rows=batch_sharding(mesh, config.batch_size),
                          prefetch=max(1, config.num_workers),
                          transfer_dtype=config.transfer_dtype,
                          device_cache=config.device_cache,
                          device_cache_budget_mb=config.device_cache_budget_mb,
                          stack_steps=max(1, config.scan_steps))
    solver = build_solver(config, train_set, encoder, decoder, mesh, writer, graph)
    # every rank the same weights, then each model rank its slices
    state = shard_state(replicate_state(solver.init_state(seed), mesh), mesh)
    return Run(seed=seed, device=device, mesh=mesh, loader=loader, solver=solver,
               state=state, say=say, writer=writer)


def build_solver(config: Config, dataset, encoder, decoder, mesh,
                 writer=None, graph: Optional[bool] = None) -> VAESolver:
    """The config's solver over these modules, with fresh optimizer
    factories (reference train.py:140-192); its step graphed as
    ``graph_step`` decides, on the modules' device."""
    device = next(encoder.parameters()).device
    return make_solver(
        config.solver,
        dataset=dataset,
        encoder=encoder,
        decoder=decoder,
        batch_size=config.batch_size,
        optimizer_e=make_optimizer(config.optimizer, config.lr),
        optimizer_d=make_optimizer(config.optimizer, config.lr),
        recon_loss_type=config.recon_loss_type,
        beta_kl=config.beta_kl,
        beta_rec=config.beta_rec,
        beta_neg=config.beta_neg,
        gamma_r=config.gamma_r,
        writer=writer,
        test_iter=config.test_iter,
        clip=config.clip,
        tc_impl=config.tc_impl,
        tc_sampling=config.tc_sampling,
        kl_kind=config.kl_kind,
        # None (auto) pairs the passes; the crossover batch past which
        # unpaired passes win is not measured on this card yet (ROADMAP
        # Queue 5 item 2)
        fuse_passes=config.fuse_passes is not False,
        mesh=mesh,
        scan_steps=max(1, config.scan_steps),
        remat_passes=config.remat == "pass",
        graph=graph_step(config, device, mesh, graph),
    )


def _train(config: Config, device: Optional[torch.device],
           graph: Optional[bool]) -> TrainState:
    run = setup(config, device, graph)
    solver, loader, group, say, writer = (run.solver, run.loader, run.group, run.say,
                                          run.writer)
    state = run.state

    # ----- resume (JAX train.py:222-240) -----
    start_epoch = config.start_epoch
    prefix = config.fingerprint()
    resume_path = config.resume
    if resume_path == "auto":  # crash recovery: newest matching checkpoint
        resume_path = find_latest_checkpoint(config.checkpoint_dir, prefix)
        if resume_path is None:
            say("resume=auto: no checkpoint found, starting fresh")
    cur_iter = 0
    if resume_path:
        state, resumed_epoch = load_checkpoint(resume_path, state, group=group)
        start_epoch = max(start_epoch, resumed_epoch)
        # the step count goes on, so later checkpoints rank after this one
        # and TensorBoard's global step keeps increasing
        cur_iter = state.step
        SingletonWriter().cur_iter = cur_iter
        say(f"resumed from {resume_path} at epoch {start_epoch} iter {cur_iter}")

    # ----- epoch loop (JAX train.py:242-348) -----
    state.model.train()
    scan_steps = max(1, config.scan_steps)
    trace_dir = f"{config.log_dir or 'runs'}/profile"
    epoch_rates: list = []  # img/s of each epoch, the wait for its last step included
    step_seconds: dict = {}  # host seconds of each queued step, by step
    last_epoch_loss = LossDict()  # the hparams table's metrics (JAX train.py:283-292)
    batch = None
    epoch = start_epoch

    def record(entries: list) -> list:
        """Drained ring entries become history records, in step order."""
        nonlocal last_epoch_loss
        for metrics, step in entries:
            rec = dict(metrics, epoch=epoch, step=step, seconds=step_seconds.pop(step))
            state.history.append(rec)
            if epoch == config.num_epochs - 1:
                last_epoch_loss += LossDict({k: rec[k] for k in
                                             ("loss_enc", "loss_dec", "loss_kl", "loss_rec")
                                             if k in rec})
            if step % PRINT_EVERY == 0:
                say(f"epoch {epoch} step {step}: loss_enc {rec['loss_enc']:.4f} "
                    f"loss_dec {rec['loss_dec']:.4f} kl {rec['loss_kl']:.4f} "
                    f"rec {rec['loss_rec']:.4f}")
        return entries

    def consume(keep_tail: int = 0) -> None:
        """The ring's entries but the newest ``keep_tail`` become history
        records, and then each is checked for a finite loss: a step that
        raises is recorded, with the steps drained beside it, as JAX writes
        a drain to TensorBoard before its check."""
        for metrics, _ in record(solver.drain_metrics(keep_tail)):
            solver.check_finite(metrics)

    try:
        with anomaly_detection(config.anomaly_detection):
            for epoch in range(start_epoch, config.num_epochs):
                # save_interval <= 0: no periodic checkpoints (the final one
                # still saves); the reference divides by zero here
                if (config.save_interval > 0
                        and epoch % config.save_interval == 0 and epoch > 0):
                    save_epoch = (epoch // config.save_interval) * config.save_interval
                    save_checkpoint(state, save_epoch, cur_iter, prefix,
                                    checkpoint_dir=config.checkpoint_dir,
                                    async_save=config.async_checkpoint, group=group)

                epoch_t0 = t_prev = time.perf_counter()
                epoch_t0_ns = time.perf_counter_ns()
                n_steps = 0
                with (profile_trace(trace_dir, enabled=config.profile),
                      contextlib.closing(iter(loader)) as batches):
                    for batch in batches:
                        if config.anomaly_detection:  # uint8 paths: normalized here
                            check_unit_range(normalize_input(batch))
                        state, _ = solver.train_step(state, batch)
                        t_now = time.perf_counter()
                        for step in range(state.step - scan_steps + 1, state.step + 1):
                            step_seconds[step] = (t_now - t_prev) / scan_steps
                        t_prev = t_now
                        n_steps += 1
                        if len(solver.metric_ring) >= RING_DEPTH + 2:
                            consume(keep_tail=2)
                        if config.profile and cur_iter >= PROFILE_STEPS:
                            break
                        cur_iter += scan_steps
                        SingletonWriter().cur_iter = cur_iter
                consume()  # waits for the last step: the epoch's time is completion-bound
                t_end = time.perf_counter()
                if n_steps:
                    state.history[-1]["seconds"] += t_end - t_prev
                    epoch_rates.append(n_steps * scan_steps * config.batch_size
                                       / (t_end - epoch_t0))
                    if writer is not None:  # loader + steps + writes, this epoch
                        writer.add_scalar("perf/images_per_sec", epoch_rates[-1], epoch)

                if config.profile:
                    say("profile:", tracing.RECORDER.summary(epoch_t0_ns))
                    break

                if epoch == config.num_epochs - 1 and batch is not None:
                    if scan_steps > 1:
                        batch = batch[-1]  # the last step's batch for the grid
                    # fresh noise, fixed by the seed and the step, as JAX's
                    # fold_in(root_key, cur_iter)
                    gen = torch.Generator(device=run.device).manual_seed(run.seed + cur_iter)
                    noise = torch.randn((config.batch_size, config.z_dim), generator=gen,
                                        device=run.device)
                    state.samples = decode(state.model.decoder, noise, train=False)
                    solver.write_images(state, batch, state.samples, cur_iter)
                    save_checkpoint(state, epoch, cur_iter, prefix,
                                    checkpoint_dir=config.checkpoint_dir,
                                    async_save=config.async_checkpoint, group=group)
    finally:
        # an abort (a non-finite loss, a loader error, Ctrl-C) still records
        # the ring's steps, which show the blow-up, unchecked so that the
        # original error propagates, and leaves no save half written
        try:
            record(solver.flush_writes())
        except Exception as flush_err:  # never mask the original error
            print(f"flush_writes failed during teardown: {flush_err!r}")
        finalize_checkpoints()

    if len(epoch_rates) > 1:  # epoch 0 includes the warm-up
        steady = float(np.median(epoch_rates[1:]))
        say(f"training throughput: {steady:,.0f} img/s "
            f"(median of epochs after the first; {len(epoch_rates)} epochs)")
    rate = images_per_second(state, config.batch_size)  # the global batch
    if rate is not None:
        mesh = run.mesh
        grid = (f"{mesh.size}" if mesh.model is None
                else f"({mesh.size} data x {mesh.model.size} model)")
        say(f"training throughput: {rate:,.1f} img/s on {grid} x "
            f"{device_name(run.device)} (steps after the first {WARMUP_STEPS}; "
            f"{len(state.history)} steps)")
    # the graphs' captures, replays, eager calls and drops, the loader's
    # batches and bytes, the hand kernels' launches (utils/tracing.py)
    say(f"counters: {tracing.RECORDER.counters()}")

    # ----- hparams table (reference train.py:244-264) -----
    if writer is not None:
        last_epoch_loss = last_epoch_loss / max(len(loader), 1)
        writer.add_hparams(
            dict(
                optimizer=config.optimizer,
                recon_loss_type=config.recon_loss_type,
                lr=config.lr,
                batch_size=config.batch_size,
                solver=config.solver,
                dataset=config.dataset,
                z_dim=config.z_dim,
                beta_kl=config.beta_kl,
                beta_neg=config.beta_neg,
                beta_rec=config.beta_rec,
                gamma_r=config.gamma_r,
                arch=config.arch,
                clip=config.clip if config.clip is not None else 0.0,
            ),
            metric_dict=dict(last_epoch_loss),
        )
        writer.close()
    return state


def images_per_second(state: TrainState, batch_size: int) -> Optional[float]:
    """Images per second of wall time over the steps after the warm-up,
    data loading and the finite checks included. Each step's seconds run
    from the previous step's enqueueing to its own, and an epoch's last
    step also holds the wait for the card to finish it, so the figure is
    bound by completion, not by enqueueing."""
    steady = state.history[WARMUP_STEPS:]
    if not steady:
        return None
    return batch_size * len(steady) / sum(r["seconds"] for r in steady)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)
