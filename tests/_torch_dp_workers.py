"""Rank workers for tests/test_torch_parallel.py.

Each worker is one rank of a data group: a process started with
``torch.multiprocessing`` (start method ``spawn``) that joins a ``gloo``
group on the CPU through the port's own start-up
(``parallel.initialize_distributed``, reading ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``ITCVAE_COORDINATOR_ADDRESS``). A spawned process
imports this module, not the test file, so nothing here imports jax.

``run_ranks(fn, world, args, out_dir)`` starts ``world`` ranks of
``fn(*args)``, waits for all of them under one hard timeout, and returns
each rank's result (saved with ``torch.save``); a rank that raises, exits
non-zero or outlives the timeout fails the call, and the other ranks are
killed rather than left waiting in a collective.
"""

from __future__ import annotations

import os
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import Synthetic
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
from intro_tc_vae_tpu_torch.models.blocks import GroupedBatchNorm
from intro_tc_vae_tpu_torch.ops.tc import IMPLS, total_correlation, total_correlation_sharded
from intro_tc_vae_tpu_torch.parallel import (
    all_gather_rows,
    all_reduce_sum,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    ranks_agree,
    replicate_state,
    shutdown_distributed,
    state_digest,
)
from intro_tc_vae_tpu_torch.solvers import TrainState, make_optimizer, make_solver
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae

CPU = torch.device("cpu")
TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank: int, world: int, port: int, args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      ITCVAE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    torch.set_num_threads(1)
    try:
        if not initialize_distributed():
            raise RuntimeError("initialize_distributed() did not join a group")
        torch.save(fn(*args), os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown_distributed()


def run_ranks(fn, world: int, args: tuple, out_dir, timeout: float = TIMEOUT) -> list:
    """``fn(*args)`` on ``world`` ranks; returns the ranks' results in order."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
           and not any(p.exitcode not in (None, 0) for p in procs)):
        time.sleep(0.05)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in hung:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors or hung:
        raise AssertionError(f"{fn.__name__} on {world} ranks failed; still running at "
                             f"the {timeout:.0f} s timeout or killed: ranks {hung}\n"
                             + "\n".join(errors))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# workers: each runs on every rank and returns what the test compares
# ---------------------------------------------------------------------------

def _count_tc_routes() -> dict:
    """Counts the TC calls of this process by route: ``ops/tc.py``'s calls
    of the gathered wrapper and of the single-device one (on the CPU the
    wrappers take their plain versions, and the kernels' counters stay 0)."""
    from intro_tc_vae_tpu_torch.ops import tc

    counts = {"gathered": 0, "single": 0}

    def spy(fn, key):
        def counted(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return counted

    tc.tc_logsumexp_cuda_gathered = spy(tc.tc_logsumexp_cuda_gathered, "gathered")
    tc.tc_logsumexp_cuda = spy(tc.tc_logsumexp_cuda, "single")
    return counts


def tc_sharded(z, mu, logvar, dataset_size: int) -> dict:
    """The global-batch TC of this rank's rows by every impl, through the
    solvers' dispatch (``total_correlation(mesh=...)``): the scalar, the
    gradients of z, mu and logvar for this rank's rows divided by the
    number of ranks (every rank's loss is the whole mean, and the
    collectives' backward sums over the ranks), and the per-sample vector
    of ``reduce='none'``."""
    mesh = make_mesh(device=CPU)
    rows = batch_sharding(mesh, z.shape[0])
    out = {}
    for impl in IMPLS:
        if impl == "pallas":
            out["routes"] = _count_tc_routes()
        args = [torch.tensor(a[rows], requires_grad=True) for a in (z, mu, logvar)]
        tc = total_correlation(*args, dataset_size, impl=impl, mesh=mesh)
        grads = torch.autograd.grad(tc, args)
        per = total_correlation_sharded(*(torch.tensor(a[rows]) for a in (z, mu, logvar)),
                                        dataset_size, mesh, reduce="none", impl=impl)
        out[impl] = dict(tc=float(tc), grads=[(g / mesh.size).numpy() for g in grads],
                         per=per.detach().numpy())
    return out


def collectives_and_bn(x, weight, bias, cot) -> dict:
    """``all_gather_rows`` and ``all_reduce_sum`` forward and backward,
    ``replicate_state`` from different initial weights, and
    ``GroupedBatchNorm`` (groups 1 and 2) on this rank's rows of each group
    of ``x`` [G, R*b, C, H, W], float64."""
    mesh = make_mesh(device=CPU)
    out = {}

    # collectives: rank r holds rows [r, r + 0.5], weights its outputs by r + 1
    a = torch.tensor([[mesh.rank + 0.0], [mesh.rank + 0.5]], dtype=torch.float64,
                     requires_grad=True)
    bank = all_gather_rows(a, mesh)
    s = all_reduce_sum(a * a, mesh)
    (ga,) = torch.autograd.grad((mesh.rank + 1.0) * (bank.sum() + s.sum()), a)
    out["bank"], out["sum"], out["grad"] = bank.detach(), s.detach(), ga

    # replicate_state: the ranks start from different weights
    torch.manual_seed(100 + mesh.rank)
    small = dict(arch="conv", cdim=3, zdim=4, channels=(4,), image_size=8)
    model = SoftIntroVAE(Encoder(**small), Decoder(**small))
    before = ranks_agree(model, mesh)
    state = replicate_state(TrainState(step=0, model=model, opt_e=None, opt_d=None,
                                       generator=None), mesh)
    out["agree_before"], out["digest"] = before, state_digest(state.model)
    out["jax_loaded"] = sorted(n for n in sys.modules
                               if n.split(".")[0] in ("jax", "jaxlib", "intro_tc_vae_tpu"))

    # grouped BatchNorm under the data group
    groups, _, c = x.shape[0], x.shape[1], x.shape[2]
    rows = batch_sharding(mesh, x.shape[1])
    for g in range(1, groups + 1):
        bn = GroupedBatchNorm(c, compute_dtype=torch.float64).double()
        bn.data_group = mesh
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        xl = torch.tensor(x[:g, rows].reshape(-1, *x.shape[2:]), requires_grad=True)
        y = bn(xl, groups=g)
        cl = torch.from_numpy(cot[:g, rows].reshape(-1, *x.shape[2:]))
        dx, dw, db = torch.autograd.grad((y * cl).sum(), (xl, bn.weight, bn.bias))
        out[f"bn{g}"] = dict(y=y.detach(), dx=dx, dw=dw, db=db,
                             running_mean=bn.running_mean.clone(),
                             running_var=bn.running_var.clone())
    return out


SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)


def solver_steps(cases: dict, init: dict, batch) -> dict:
    """One step of each case ({label: (solver name, paired, global noise,
    solver hyperparameters)})
    on this rank's rows of the global ``batch`` (NHWC, float64), from the
    weights ``init`` (port state dict), float64, tc_impl 'pallas'
    (the gathered kernels' plain version on the CPU). Returns the metrics,
    the state dict and its digest, and the TC calls by route per case."""
    out, routes = {}, _count_tc_routes()
    for label, (name, paired, noise, hyper) in cases.items():
        mesh = make_mesh(device=CPU)
        enc = Encoder(**SMALL, compute_dtype=torch.float64)
        dec = Decoder(**SMALL, compute_dtype=torch.float64)
        model = SoftIntroVAE(enc, dec).double()
        model.load_state_dict(init)
        solver = make_solver(
            name, dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
            encoder=enc, decoder=dec, batch_size=batch.shape[0],
            optimizer_e=make_optimizer("adam", 2e-4),
            optimizer_d=make_optimizer("adam", 2e-4), tc_impl="pallas",
            fuse_passes=paired, mesh=mesh, **hyper)
        state = replicate_state(solver.init_state(0), mesh)
        x = torch.from_numpy(batch[batch_sharding(mesh, batch.shape[0])]
                             .transpose(0, 3, 1, 2).copy())
        routes.update(gathered=0, single=0)
        state, metrics = solver.train_step(
            state, x, noise={k: torch.from_numpy(v) for k, v in noise.items()})
        out[label] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          state={k: v.clone() for k, v in model.state_dict().items()},
                          digest=state_digest(model), routes=dict(routes))
    return out


def train_cli_config(config_path: str, update: dict, bad_updates: list) -> dict:
    """``train_soft_intro_vae`` under the data group on the CPU: first each
    of ``bad_updates`` (its error type and message, or None), then
    ``update``: the history and the final state's digest."""
    errors = []
    for bad in bad_updates:
        try:
            train_soft_intro_vae(load_config(config_path, {**update, **bad}), device=CPU)
            errors.append(None)
        except (ValueError, NotImplementedError) as e:
            errors.append((type(e).__name__, str(e)))
    routes = _count_tc_routes()
    state = train_soft_intro_vae(load_config(config_path, update), device=CPU)
    return dict(errors=errors, history=state.history, digest=state_digest(state.model),
                routes=routes)


def _dp_solver(init: dict, batch_size: int, mesh=None, bump: float = 0.0):
    """The small float64 intro_tc solver from the weights ``init`` (plus
    ``bump`` on every parameter), under ``mesh`` or in one process."""
    enc = Encoder(**SMALL, compute_dtype=torch.float64)
    dec = Decoder(**SMALL, compute_dtype=torch.float64)
    model = SoftIntroVAE(enc, dec).double()
    model.load_state_dict(init)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(bump)
    solver = make_solver(
        "intro_tc", dataset=Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4)),
        encoder=enc, decoder=dec, batch_size=batch_size,
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        tc_impl="pallas", mesh=mesh, beta_kl=0.5, beta_rec=0.75, beta_neg=512.0)
    state = solver.init_state(0)
    return solver, (state if mesh is None else replicate_state(state, mesh))


def checkpoint_resume(init: dict, batches: list, noises: list, ckpt_dir: str) -> dict:
    """One step on this rank's rows, a background save (rank 0 writes),
    then every rank loads it into a fresh state built from other weights
    and takes the second step from there. Returns the digests of the saved
    and the loaded state, the writes this rank made, and the second step's
    metrics and state dict."""
    from intro_tc_vae_tpu_torch.utils import checkpoint

    writes = []
    write = checkpoint._write
    checkpoint._write = lambda payload, path: (writes.append(path), write(payload, path))
    mesh = make_mesh(device=CPU)
    rows = batch_sharding(mesh, batches[0].shape[0])

    def x(batch):
        return torch.from_numpy(batch[rows].transpose(0, 3, 1, 2).copy())

    solver, state = _dp_solver(init, batches[0].shape[0], mesh)
    solver.train_step(state, x(batches[0]), noise=noises[0])
    saved = state_digest(state.model)
    path = checkpoint.save_checkpoint(state, 0, state.step, "dp_", checkpoint_dir=ckpt_dir,
                                      async_save=True, group=mesh)
    solver_r, restored = _dp_solver(init, batches[0].shape[0], mesh, bump=0.5)
    checkpoint.load_checkpoint(path, restored, group=mesh)  # waits for rank 0's write
    loaded = state_digest(restored.model)
    step = restored.step
    _, metrics = solver_r.train_step(restored, x(batches[1]), noise=noises[1])
    checkpoint.finalize_checkpoints()
    return dict(saved=saved, loaded=loaded, step=step, writes=writes,
                metrics={k: float(v) for k, v in metrics.items()},
                state={k: v.clone() for k, v in restored.model.state_dict().items()},
                digest=state_digest(restored.model))


def loader_rows(imgs, batch_size: int, seed: int) -> dict:
    """This rank's loader over a uint8 array dataset of ``imgs`` [N, H, W,
    C] (stored at its target size): one epoch with the defaults auto /
    auto, which under data parallel decline the cache and transfer this
    rank's rows of each global batch as uint8; and the error of
    ``device_cache: "force"``."""
    from intro_tc_vae_tpu_torch.data import DeviceLoader
    from intro_tc_vae_tpu_torch.data.datasets import _ArrayDataset

    mesh = make_mesh(device=CPU)
    ds = _ArrayDataset(imgs, np.zeros((len(imgs), 1)), resize=imgs.shape[1])
    rows = batch_sharding(mesh, batch_size)
    loader = DeviceLoader(ds, batch_size, CPU, seed=seed, rows=rows,
                          transfer_dtype="auto", device_cache="auto")
    batches = list(loader)
    forced = DeviceLoader(ds, batch_size, CPU, seed=seed, rows=rows, device_cache="force")
    try:
        list(forced)
        force_error = None
    except ValueError as e:
        force_error = str(e)
    return dict(batches=batches, cache=loader.cache is not None, rows=(rows.start, rows.stop),
                force_error=force_error)
