"""Driver of the ``train`` mix: one trainer in a closed loop over the
seeded corpus, epoch after epoch, as ``intro_tc_vae_tpu_torch.train``'s
step loop runs it without its checkpoints and writer.

Set-up (``build``): the corpus and the weights are made from the seed;
``train.setup(config, device)`` builds the loader and the solver over the
corpus (its dataset factory handed the corpus); the weights are copied
into the model. Then the run's first steps go through the same call and
feed as the window's (``_step``), in three stages (``Stage``):

* ``start``: steps 1-3, the graphed step's eager warm-up, from the seed's
  weights and fresh optimizers;
* step 4, the capture's (a capture runs nothing: its step is the graph's
  first replay), unchecked;
* ``replay``: steps 5-7, three replays of the graph the window replays,
  each filling the graph's static batch and noise as the window's do,
  from a snapshot of the program's state (parameters and Adam's moments
  and step count, on the host) taken just before them;
* ``warmup_steps`` more replays, unchecked.

Of each checked stage the program's losses, its first gradient as Adam
took it (worked out from the moments after the stage's first step and
before it) and its parameters after the third step are kept on the host.

The program runs as ``train.py`` runs it: ``build`` and ``window`` hold
``train.true_fp32`` for the configuration's precision, so an "fp32"
configuration's convolutions and matrix products are fp32 proper, not
TF32 (a "bf16" one leaves the switches as they are).

The window (``window``) repeats, per epoch: ``iter(loader)``, then for
each batch ``solver.train_step(state, batch, noise)`` with the step's
noise drawn by the harness, a CUDA event after it, and
``drain_metrics(keep_tail=2)`` once ``RING_DEPTH + 2`` entries are queued;
at an epoch's end the whole ring is drained, which waits for its last
step. The window closes at the first step that ends past ``seconds`` and
the device has finished it.

The check (``check``) runs once the window is closed and the program's
state is freed: for each stage the reference (``reference/model.py``,
float32, TF32 off) takes the same three steps from the stage's starting
state, on the same batches (the loader's seeded order and the corpus'
flip flags, worked out again) and noise, and ``compare`` reads the gaps,
``<stage>.<number>``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Optional

import numpy as np
import torch

from perfbench.core import data
from perfbench.core.common import arch_of, no_tf32, sync
from perfbench.core.spans import Spans
from perfbench.reference import model as ref

CHECKED_STEPS = 3
BETA1 = ref.ADAM_BETAS[0]
STAGES = ("start", "replay")


@dataclasses.dataclass
class Stage:
    """``CHECKED_STEPS`` steps the reference follows: ``first``, the
    0-based index of the first in the first epoch; ``origin``, the state
    they start from (None: the seed's weights and fresh optimizers; else
    the program's ``params``, Adam's ``m``, ``v`` and step count ``t``);
    the noise handed to each; and what the program gave: each step's
    (loss_enc, loss_dec), the first step's gradient and the parameters
    after the last, by leaf name."""

    first: int
    origin: Optional[dict] = None
    noise: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    grad1: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    arch: ref.Arch
    hyper: ref.Hyper
    batch: int
    seeds: dict
    corpus: data.Corpus
    loader_seed: int
    run: object = None
    it: object = None
    ring_depth: int = 0
    noise_gen: Optional[torch.Generator] = None
    spans: Spans = dataclasses.field(default_factory=Spans)
    stages: dict = dataclasses.field(default_factory=dict)
    reference: dict = dataclasses.field(default_factory=dict)  # stage -> its trajectory


def hyper_of(cell, dataset_size: int) -> ref.Hyper:
    c = cell.config["config"]
    return ref.Hyper(beta_kl=c["beta_kl"], beta_rec=c["beta_rec"], beta_neg=c["beta_neg"],
                     gamma_r=c["gamma_r"], lr=c["lr"], dataset_size=dataset_size)


@contextlib.contextmanager
def dataset_factory(train_module, corpus, arch: ref.Arch):
    """``train.setup`` reads its dataset from ``train.load_dataset``: for
    the block, that factory hands it the corpus."""
    original = train_module.load_dataset

    def load(name, data_root=None):
        return corpus, arch.image_size, list(arch.channels), arch.cdim

    train_module.load_dataset = load
    try:
        yield
    finally:
        train_module.load_dataset = original


def copy_weights(module: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's weights into ``module``'s parameters, in place;
    every parameter must be named and shaped as the reference's leaf."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the program's leaves differ from the reference's: "
                           f"{sorted(set(params) ^ set(weights))[:6]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: {tuple(p.shape)} in the program, "
                                   f"{tuple(weights[name].shape)} in the reference")
            p.copy_(weights[name])


def program_precision(cell):
    """``train.true_fp32`` for the cell's precision: the TF32 switches as
    ``train.py`` sets them around its run."""
    from intro_tc_vae_tpu_torch.train import true_fp32

    return true_fp32(cell.config["config"]["precision"])


def build(cell, seed: int, device) -> Session:
    """Everything before the window; see the module docstring."""
    with program_precision(cell):
        return _build(cell, seed, device)


def _build(cell, seed: int, device) -> Session:
    from intro_tc_vae_tpu_torch import train as program_train
    from intro_tc_vae_tpu_torch.config import Config
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH

    device = torch.device(device)
    traffic = cell.traffic
    seeds = data.sub_seeds(seed)
    arch = arch_of(cell)
    spans = Spans()
    with spans("setup_corpus"):
        images = data.make_corpus(int(traffic["corpus_images"]), arch.image_size, arch.cdim,
                                  seeds["corpus"], device)
    corpus = data.Corpus(images, seeds["flips"])
    config = Config(**dict(cell.config["config"], seed=seeds["program"]))
    warmup = int(traffic["warmup_steps"])
    with spans("setup_program"), dataset_factory(program_train, corpus, arch):
        run = program_train.setup(config, device)
    with spans("setup_weights"):
        copy_weights(run.state.model, ref.make_weights(arch, seeds["weights"], device))
    run.state.model.train()
    s = Session(cell=cell, seed=seed, device=device, arch=arch,
                hyper=hyper_of(cell, len(corpus)), batch=config.batch_size, seeds=seeds,
                corpus=corpus, loader_seed=run.seed, run=run, ring_depth=RING_DEPTH,
                noise_gen=torch.Generator(device=device).manual_seed(seeds["noise"]),
                spans=spans)
    # the replay stage starts after the graphed step's capture (eager runs:
    # right after the start stage); the steps before it run unchecked
    graphed = run.solver.graphed
    replay_first = max(CHECKED_STEPS, graphed.warmup + 1 if graphed is not None else 0)
    if replay_first + CHECKED_STEPS > len(corpus) // config.batch_size:
        raise ValueError("the checked steps must lie in the corpus' first epoch")
    s.it = iter(run.loader)
    with spans("setup_first_steps"):
        follow(s, Stage(first=0))
        for _ in range(replay_first - CHECKED_STEPS):
            _step(s)
        follow(s, Stage(first=replay_first, origin=snapshot(run.state)))
    with spans("setup_warmup"):
        for _ in range(warmup):
            _step(s)
        _drain(s, 0)
        sync(device)
    return s


def _leaf_names(state) -> dict:
    return {p: n for n, p in state.model.named_parameters()}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def moments(state, key: str) -> dict:
    """Adam's ``key`` ("exp_avg" or "exp_avg_sq") of every leaf, on the
    host."""
    names = _leaf_names(state)
    return {names[p]: _host(st[key])
            for opt in (state.opt_e, state.opt_d) for p, st in opt.state.items()}


def snapshot(state) -> dict:
    """The program's state on the host: parameters, Adam's two moments and
    its step count (one for both optimizers, which step together)."""
    counts = {int(st["step"]) for opt in (state.opt_e, state.opt_d)
              for st in opt.state.values()}
    if len(counts) != 1:
        raise RuntimeError(f"the optimizers' step counts differ: {sorted(counts)}")
    return {"params": {n: _host(p) for n, p in state.model.named_parameters()},
            "m": moments(state, "exp_avg"), "v": moments(state, "exp_avg_sq"),
            "t": counts.pop()}


def follow(s: Session, stage: Stage) -> None:
    """The stage's steps through ``_step``; keeps what the comparison
    reads: each step's two losses, the first step's gradient as Adam took
    it, (m after - beta1 m before) / (1 - beta1), and the parameters after
    the last step, all on the host. The ring is drained before and after."""
    state = s.run.state
    _drain(s, 0)
    m0 = stage.origin["m"] if stage.origin is not None else None
    for k in range(CHECKED_STEPS):
        _step(s, keep_noise=stage.noise)
        if k == 0:
            m1 = moments(state, "exp_avg")
            stage.grad1 = {n: (m - (BETA1 * m0[n] if m0 is not None else 0.0)) / (1.0 - BETA1)
                           for n, m in m1.items()}
    stage.params = {n: _host(p) for n, p in state.model.named_parameters()}
    stage.losses = [(m["loss_enc"], m["loss_dec"]) for m, _ in _drain(s, 0)]
    s.stages["replay" if stage.origin is not None else "start"] = stage


def _drain(s: Session, keep_tail: int) -> list:
    drained = s.run.solver.drain_metrics(keep_tail)
    for metrics, _ in drained:
        s.run.solver.check_finite(metrics)
    return drained


def _step(s: Session, keep_noise: Optional[list] = None) -> None:
    """One step of the loop: the next batch (a new epoch's iterator at the
    end of one, after draining the ring), the step's noise (kept on the
    host in ``keep_noise``, if given), the call, and a drain two behind
    once the ring holds RING_DEPTH + 2."""
    run, spans = s.run, s.spans
    with spans("loader_next"):
        batch = next(s.it, None)
    if batch is None:
        with spans("drain"):
            _drain(s, 0)
        with spans("loader_next"):
            s.it = iter(run.loader)
            batch = next(s.it)
    noise = data.step_noise(s.noise_gen, s.batch, s.arch.zdim, ref.NOISE_KEYS, s.device)
    if keep_noise is not None:
        keep_noise.append({k: _host(v) for k, v in noise.items()})
    with spans("train_step"):
        run.solver.train_step(run.state, batch, noise)
    if len(run.solver.metric_ring) >= s.ring_depth + 2:
        with spans("drain"):
            _drain(s, 2)


@dataclasses.dataclass
class Window:
    seconds: float
    steps: int
    images: int
    intervals_s: list
    lo: float
    hi: float
    trace: object = None
    traced: tuple = ()  # (t_on, t_off) of the traced stretch on the host clock
    trace_units: int = 0  # steps the traced stretch covered

    @property
    def units(self) -> int:
        return self.steps


def window(s: Session, seconds: float, trace: bool) -> Window:
    """The timed window; with ``trace``, a profiler over a steady stretch
    of it (see ``core/profiled.py``)."""
    with program_precision(s.cell):
        return _window(s, seconds, trace)


def _window(s: Session, seconds: float, trace: bool) -> Window:
    from perfbench.core.profiled import Stretch

    cuda = s.device.type == "cuda"
    stretch = Stretch(s.spans, s.device) if trace else None
    stamps = []
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    t0 = time.perf_counter()
    if cuda:
        start.record()
    steps = 0
    while True:
        if stretch is not None:
            stretch.before(steps, time.perf_counter() - t0, seconds)
        _step(s)
        steps += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
        else:
            stamps.append(time.perf_counter())
        if stretch is not None:
            stretch.after(steps)
        if time.perf_counter() - t0 >= seconds:
            break
    sync(s.device)
    t1 = time.perf_counter()
    if stretch is not None:
        stretch.close(steps)
    if cuda:
        ms = [start.elapsed_time(stamps[0])] + [a.elapsed_time(b)
                                                for a, b in zip(stamps, stamps[1:])]
        intervals = [m / 1e3 for m in ms]
    else:
        intervals = [b - a for a, b in zip([t0] + stamps, stamps)]
    _drain(s, 0)  # outside the window
    return Window(seconds=t1 - t0, steps=steps, images=steps * s.batch,
                  intervals_s=intervals, lo=t0, hi=t1,
                  trace=stretch.trace if stretch is not None else None,
                  traced=(stretch.t_on, stretch.t_off) if stretch and stretch.t_on else (),
                  trace_units=stretch.units if stretch is not None else 0)


def free(s: Session) -> None:
    """Drop the program's state (model, optimizers, graphs, loader and its
    device cache) before the reference runs."""
    s.it = None
    s.run = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def reference_trajectory(s: Session, stage: Stage, quantizer=None,
                         half_batch: bool = False) -> dict:
    """The reference's steps of ``stage`` on the run's inputs, from the
    stage's starting state: each step's (loss_enc, loss_dec), the norm of
    each leaf's first gradient, and the norm of each leaf's change over
    the steps. ``quantizer`` and ``half_batch`` make a control or a fault
    out of it."""
    dev = s.device
    q = ref.QUANTIZERS[quantizer]
    order = data.epoch_order(len(s.corpus), s.loader_seed)
    o = stage.origin
    with no_tf32():
        if o is None:
            params = ref.make_weights(s.arch, s.seeds["weights"], dev)
            opts = [ref.Adam(s.hyper.lr), ref.Adam(s.hyper.lr)]
        else:
            params = {k: v.to(dev) for k, v in o["params"].items()}
            opts = [ref.Adam(s.hyper.lr, m={k: o["m"][k].to(dev) for k in part},
                             v={k: o["v"][k].to(dev) for k in part}, t=o["t"])
                    for part in ref.split(params)]
        start = {k: v.clone() for k, v in params.items()}
        losses, grad1 = [], None
        for k in range(CHECKED_STEPS):
            step = stage.first + k
            x = data.reference_batch(s.corpus.images, order, s.corpus.flags[step], step,
                                     s.batch, dev)
            noise = {name: v.to(dev) for name, v in stage.noise[k].items()}
            if half_batch:
                x = x[: s.batch // 2]
                noise = {name: v[: s.batch // 2] for name, v in noise.items()}
            out = ref.intro_tc_step(params, *opts, s.arch, s.hyper, x, noise, q)
            losses.append((float(out["loss_enc"]), float(out["loss_dec"])))
            if k == 0:
                grad1 = _norms({**out["grads_e"], **out["grads_d"]})
            del out
        change = _norms({k: params[k] - start[k] for k in params})
    return {"losses": losses, "grad1": grad1, "change": change}


def program_trajectory(stage: Stage, start: dict) -> dict:
    """The program's numbers of ``stage``, from what ``follow`` kept;
    ``start``: the parameters the stage started from, on the host."""
    return {"losses": stage.losses, "grad1": _norms(stage.grad1),
            "change": _norms({k: stage.params[k] - start[k] for k in stage.params})}


def worst_leaf_gap(prog: dict, ref_norms: dict, keep) -> tuple:
    """max over the kept leaves of |prog - ref| / max(ref, the median
    leaf's ref): (gap, leaf)."""
    median = float(np.median([ref_norms[k] for k in keep]))
    worst = (0.0, None)
    for k in keep:
        gap = abs(prog[k] - ref_norms[k]) / max(ref_norms[k], median)
        if not math.isfinite(gap):
            return (math.inf, k)
        worst = max(worst, (gap, k))
    return worst


def compare(prog: dict, refr: dict) -> dict:
    """The numbers the limits may hold: ``loss_gap`` (the worst relative
    gap of the six losses), ``first_loss_gap`` (the first step's encoder
    loss), ``grad_gap`` (the worst leaf's gap of first-gradient norms),
    ``median_grad_gap`` (the median leaf's gap of the same norms),
    ``change_gap`` (the worst leaf's gap of the norms of the change over
    the steps, leaves whose reference gradient is under a thousandth of
    the median leaf's left out: round-off alone moves those under Adam),
    and ``median_change_gap`` (the median leaf's gap of the same norms).
    Each step's gaps are in ``loss_gaps``."""
    gaps = []
    for (pe, pd), (re_, rd) in zip(prog["losses"], refr["losses"]):
        gaps.append([abs(p - r) / abs(r) for p, r in ((pe, re_), (pd, rd))])
    flat = [g if math.isfinite(g) else math.inf for pair in gaps for g in pair]
    complete = len(prog["losses"]) == len(refr["losses"]) and flat
    leaves = sorted(refr["grad1"])
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad1"], refr["grad1"], leaves)
    median_g = float(np.median([refr["grad1"][k] for k in leaves]))
    grad_gaps = [abs(prog["grad1"][k] - refr["grad1"][k]) / max(refr["grad1"][k], median_g)
                 for k in leaves]
    moved = [k for k in leaves if refr["grad1"][k] >= 1e-3 * median_g]
    change_gap, change_leaf = worst_leaf_gap(prog["change"], refr["change"], moved)
    median_c = float(np.median([refr["change"][k] for k in moved]))
    per_leaf = sorted(abs(prog["change"][k] - refr["change"][k]) / max(refr["change"][k], median_c)
                      for k in moved)
    return {"loss_gap": max(flat) if complete else math.inf,
            "first_loss_gap": flat[0] if complete else math.inf,
            "grad_gap": grad_gap, "median_grad_gap": float(np.median(grad_gaps)),
            "change_gap": change_gap,
            "median_change_gap": float(np.median(per_leaf)),
            "loss_gaps": gaps, "leaves": len(leaves), "leaves_moved": len(moved),
            "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf}


def check(s: Session, stand_in: Optional[str] = None) -> dict:
    """The comparison's numbers for this run, ``<stage>.<number>`` for
    each stage. ``stand_in``: "fp8" or "half_batch" puts the reference,
    so changed, in the program's place."""
    out = {}
    for name in STAGES:
        stage = s.stages[name]
        if name not in s.reference:
            s.reference[name] = reference_trajectory(s, stage)
        refr = s.reference[name]
        if stand_in is None:
            start = (stage.origin["params"] if stage.origin is not None else
                     {k: v.cpu() for k, v in
                      ref.make_weights(s.arch, s.seeds["weights"], s.device).items()})
            prog = program_trajectory(stage, start)
        elif stand_in == "fp8":
            prog = reference_trajectory(s, stage, quantizer="fp8")
        elif stand_in == "half_batch":
            prog = reference_trajectory(s, stage, half_batch=True)
        else:
            raise ValueError(f"stand_in {stand_in!r}")
        out.update({f"{name}.{k}": v for k, v in compare(prog, refr).items()})
    return out


def end_to_end(win: Window) -> dict:
    """``train_img_s``: every image of every step completed in the window
    over the window; ``train_step_ms_p95``: the 95th percentile of all
    the window's step completion intervals (CUDA events after each step,
    read once the window has closed)."""
    from perfbench.core.stats import percentile, rate

    return {"train_img_s": rate(win.images, win.seconds),
            "train_step_ms_p95": 1e3 * percentile(win.intervals_s, 95)}
