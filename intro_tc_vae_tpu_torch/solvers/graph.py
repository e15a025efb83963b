"""The single-process train step as one captured CUDA graph.

Counterpart of ``jax.jit(step, donate_argnums=(0,))`` (JAX
solvers/base.py:378): the JAX step is one compiled program, dispatched
once a step; an eager PyTorch step dispatches every tensor op from the
host, which then bounds the step. ``GraphedStep`` wraps the step that
``VAESolver.build_step`` returns, step(state, batch, noise) -> metrics,
and runs it as one ``torch.cuda.CUDAGraph``:

* Static buffers hold the batch as it is given (uint8 stays uint8: the
  graph runs ``normalize_input``) and each noise key's [B, z] draw. A call
  copies its batch in, and draws the step's noise into them eagerly from
  ``state.generator`` with ``draw_noise``, the draws ``step_noise`` makes,
  in its order (or copies in the caller's ``noise``): the random stream is
  the eager step's, draw for draw, and no generator is registered with
  the graph.
* The body is the step on those buffers, its metrics stacked into one
  float32 [n] tensor, the metric ring's row (``MetricRing.push_stacked``
  copies it to the host after the replay).
* Warm-up: the first ``WARMUP_STEPS`` calls run the body eagerly on the
  current stream. They are real steps, and they fill every lazy state
  outside the capture: the optimizers' moments, the kernels' attributes,
  the cached tables. The next call captures the body and replays it: a
  capture records work and runs none, so the first replay is that call's
  step. Every later call is one replay. The warm-up takes no stream of its
  own: PyTorch keeps a cuBLAS workspace for every stream a matrix product
  ran on for the life of the process (65 MiB on an H100, allocated through
  the caching allocator), so a side stream per graphed step would hold
  that much device memory after its run is gone.
* ``state.step`` and the Python bookkeeping stay outside the graph: the
  capture's increment is undone, and each replay adds one.
* A capture holds the addresses it recorded. A call that finds a
  parameter, buffer or optimizer-state tensor replaced (by data pointer),
  another optimizer or learning rate drops the graph; that call captures
  again once the optimizers hold their state (else it runs eager first).
  ``load_state_dict`` into an optimizer is such a case; copies in place (a
  model's ``load_state_dict``) keep the graph. A batch of another shape or
  dtype drops it too and runs one eager step before the next capture, so
  that the module-level caches its shapes key (filled on first use) are
  filled outside a capture: nothing cached comes from a graph's pool.
* The launch counters keep counting: the capture's launches are the
  graph's tally (``ops/launch_counts.py``), added on every replay.
* A failed capture raises. Nothing falls back to eager.
* The recorder (``utils/tracing.py``) times a call's parts as spans and
  reads the counters ``captures``, ``replays``, ``eager`` (calls run
  eagerly) and ``drops`` (graphs dropped, by reason: ``signature`` or
  ``shape``). The body brackets the step with the device phase stamps and
  stacks their segments after its metrics (``phase_names``).

``GraphedEval`` does the same for an eval-mode pass, fn(inp) -> a tensor
or a tuple of tensors (the metric pipeline's encoder, the serving path's
decode and encode): the counterpart of the ``jax.jit`` of such a pass (JAX
solvers/base.py:593-612, bench.py:151-170). It keeps one graph for each
input shape and dtype, as ``jit`` compiles one program for each, and at
most ``MAX_EVAL_GRAPHS`` of them, all in one private memory pool.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from intro_tc_vae_tpu_torch.ops import launch_counts
from intro_tc_vae_tpu_torch.utils import tracing

WARMUP_STEPS = 3  # eager steps before the capture
EVAL_WARMUP_CALLS = 1  # eager calls of an eval pass, per input shape, before its capture
# graphs a GraphedEval keeps: the metric families encode in batch_size
# chunks and one remainder, the serving path at one batch
MAX_EVAL_GRAPHS = 2


class CudaGraph:
    """``torch.cuda.CUDAGraph`` with its capture context, the interface
    ``GraphedStep`` and ``GraphedEval`` take (a test passes another).
    ``pool``: another graph's ``pool()``, whose private memory pool the
    capture shares; None gives the graph a pool of its own."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self._pool = pool

    def capture(self):
        return torch.cuda.graph(self.graph, pool=self._pool)

    def replay(self) -> None:
        self.graph.replay()

    def pool(self):
        return self.graph.pool()


class GraphedStep:
    """``step`` (state, batch, noise) -> metrics dict as a captured graph;
    a call returns (metric names, float32 [n + m] metrics then the step's
    m device phase segments, ``phase_names``). The returned tensor of a
    replay is the graph's static output: the next call overwrites it, so
    the caller copies it first."""

    def __init__(self, step: Callable, noise_keys: Sequence[str], zdim: int,
                 graph_factory: Callable = CudaGraph, warmup: int = WARMUP_STEPS):
        self.step = step
        self.noise_keys = tuple(noise_keys)
        self.zdim = zdim
        self.graph_factory = graph_factory
        self.warmup = warmup
        self.warm = 0                 # eager steps taken
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.drops = {"signature": 0, "shape": 0}
        self.names: tuple = ()
        self.phase_names: tuple = ()
        self.graph = None
        self.tally: Optional[launch_counts.Tally] = None
        self._batch: Optional[torch.Tensor] = None
        self._noise: dict = {}
        self._out: Optional[torch.Tensor] = None
        self._signature = None
        tracing.watch(self)

    def counters(self) -> dict:
        return {"captures": self.captures, "replays": self.replays, "eager": self.eager,
                "drops": dict(self.drops)}

    # -- buffers ----------------------------------------------------------

    def fill(self, state, batch: torch.Tensor, noise: Optional[dict] = None) -> None:
        """Copy the batch into the static batch and the step's noise into
        the static noise: ``noise``'s tensors, or fresh draws from
        ``state.generator`` (``draw_noise``: ``step_noise``'s draws)."""
        from intro_tc_vae_tpu_torch.solvers.base import draw_noise

        if noise is None:
            noise = draw_noise(state.generator, batch.shape[0], self.zdim, batch.device,
                               self.noise_keys)
        wanted = [("batch", batch)] + [(k, noise[k]) for k in self.noise_keys]
        for key, src in wanted:
            buf = self._batch if key == "batch" else self._noise.get(key)
            if (buf is None or buf.shape != src.shape or buf.dtype != src.dtype
                    or buf.device != src.device):
                if self.graph is not None:
                    self.drops["shape"] += 1
                self.drop()  # the graph read the old buffers
                # one eager step first: it fills the caches the new shapes
                # key (the TC weights, tables), which a capture cannot
                self.warm = min(self.warm, self.warmup - 1)
                buf = torch.empty_like(src, memory_format=torch.contiguous_format)
                if key == "batch":
                    self._batch = buf
                else:
                    self._noise[key] = buf
            buf.copy_(src)

    def body(self, state) -> torch.Tensor:
        """The step on the static buffers, its metrics and phase segments
        stacked: [n + m]."""
        from intro_tc_vae_tpu_torch.solvers.base import normalize_input

        tracing.open_phases()
        metrics = self.step(state, normalize_input(self._batch), self._noise)
        self.phase_names, seg = tracing.close_phases(self._batch)
        self.names = tuple(metrics)
        cols = [v.detach().float().reshape(()) for v in metrics.values()]
        return torch.stack(cols + (list(seg.unbind()) if seg is not None else []))

    # -- the graph --------------------------------------------------------

    def drop(self) -> None:
        """Forget the graph; the next call that may captures again."""
        self.graph = self.tally = self._out = self._signature = None

    @staticmethod
    def _tensors(state) -> list:
        tensors = list(state.model.parameters()) + list(state.model.buffers())
        for opt in (state.opt_e, state.opt_d):
            for per_param in opt.state.values():
                tensors.extend(v for v in per_param.values() if torch.is_tensor(v))
        return tensors

    def signature(self, state) -> tuple:
        """What a capture holds on to: the optimizers, their learning
        rates, and every state tensor's address."""
        opts = (state.opt_e, state.opt_d)
        return (tuple(map(id, opts)),
                tuple(g["lr"] for o in opts for g in o.param_groups),
                tuple(t.data_ptr() for t in self._tensors(state)))

    @staticmethod
    def _initialized(state) -> bool:
        """Every optimizer holds its state (plain SGD, momentum 0, keeps
        none): a capture would otherwise record the state's creation (its
        zero fill) into every replay."""
        return all(isinstance(opt, torch.optim.SGD)
                   or all(p in opt.state for g in opt.param_groups for p in g["params"])
                   for opt in (state.opt_e, state.opt_d))

    def _capture(self, state) -> None:
        graph = self.graph_factory()
        step = state.step
        with launch_counts.recording() as tally, graph.capture():
            out = self.body(state)
        state.step = step  # the capture ran no step
        self.graph, self.tally, self._out = graph, tally, out
        self._signature = self.signature(state)
        self.captures += 1

    def __call__(self, state, batch: torch.Tensor, noise: Optional[dict] = None):
        with tracing.span("step.fill"):
            self.fill(state, batch, noise)
        if self.graph is not None:
            with tracing.span("step.check"):
                changed = self.signature(state) != self._signature
            if changed:
                self.drops["signature"] += 1
                self.drop()
        if self.graph is None:
            if self.warm < self.warmup or not self._initialized(state):
                self.warm += 1
                self.eager += 1
                with tracing.span("step.eager"):
                    out = self.body(state)  # sets self.names
                return self.names, out
            with tracing.span("step.capture"):
                self._capture(state)
        with tracing.span("step.launch"):
            self.graph.replay()
        self.tally.add()
        self.replays += 1
        state.step += 1
        return self.names, self._out


class GraphedEval:
    """``fn(inp)`` -> a tensor or a tuple of tensors, an eval-mode pass
    that reads ``modules``' parameters and buffers, as a captured graph for
    each input shape and dtype.

    * The first ``EVAL_WARMUP_CALLS`` calls for a shape run ``fn`` eagerly
      on the current stream (no side stream: see ``GraphedStep``); they
      fill the lazy caches, such as ``normalize_input``'s table, that a
      capture cannot. The next call captures ``fn`` on a static copy of the
      input and replays it; every later call copies its input into that
      buffer and replays.
    * The graphs share one private memory pool: a capture may reuse what
      another graph's pass frees, so a replay may overwrite the outputs of
      any earlier call. A call returns the graph's static outputs, and the
      caller copies them before its next call.
    * ``fn`` holds the parameters and buffers by address, so a replay reads
      their values as they are then: copies in place (a model's
      ``load_state_dict``, the optimizers' updates, BatchNorm's running
      statistics) keep the graphs; a replaced parameter or buffer (by data
      pointer) drops them all, and the next call of a shape runs eager
      again before it captures.
    * At most ``MAX_EVAL_GRAPHS`` graphs: a new shape beyond them drops the
      graph used longest ago.
    * The launch counters keep counting: a capture's launches are its
      graph's tally, added on every replay (``ops/launch_counts.py``).
    * A failed capture raises and keeps no graph. Nothing falls back to
      eager.
    * The recorder times a call's parts as spans and reads the counters, as
      ``GraphedStep``'s (a graph evicted for a new shape is a ``shape``
      drop)."""

    def __init__(self, fn: Callable, modules: Sequence[torch.nn.Module],
                 graph_factory: Callable = CudaGraph):
        self.fn = fn
        self.modules = tuple(modules)
        self.graph_factory = graph_factory
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.drops = {"signature": 0, "shape": 0}
        self._warm: dict = {}    # input key -> eager calls made
        # input key -> (graph, tally, static input, outputs), least recently used first
        self._graphs: dict = {}
        self._signature = None
        tracing.watch(self)

    counters = GraphedStep.counters

    def signature(self) -> tuple:
        """Every parameter's and buffer's address."""
        return tuple(t.data_ptr() for m in self.modules
                     for t in (*m.parameters(), *m.buffers()))

    def drop(self) -> None:
        """Forget every graph (and with the last one their pool); each
        shape warms up again."""
        self._graphs.clear()
        self._warm.clear()

    def _capture(self, inp: torch.Tensor) -> tuple:
        if len(self._graphs) >= MAX_EVAL_GRAPHS:
            del self._graphs[next(iter(self._graphs))]
            self.drops["shape"] += 1
        static = torch.empty_like(inp, memory_format=torch.contiguous_format)
        static.copy_(inp)
        kept = next(iter(self._graphs.values()), None)
        graph = self.graph_factory(pool=kept[0].pool() if kept is not None else None)
        with launch_counts.recording() as tally, graph.capture():
            out = self.fn(static)
        self.captures += 1
        return graph, tally, static, out

    def __call__(self, inp: torch.Tensor):
        with tracing.span("eval", unit=self.replays + self.eager + 1):
            with tracing.span("eval.check"):
                signature = self.signature()
            if signature != self._signature:
                if self._graphs:
                    self.drops["signature"] += 1
                self.drop()
                self._signature = signature
            key = (tuple(inp.shape), inp.dtype, inp.device)
            entry = self._graphs.pop(key, None)
            if entry is None:
                if self._warm.get(key, 0) < EVAL_WARMUP_CALLS:
                    self._warm[key] = self._warm.get(key, 0) + 1
                    self.eager += 1
                    with tracing.span("eval.eager"):
                        return self.fn(inp)
                with tracing.span("eval.capture"):
                    entry = self._capture(inp)
            else:
                with tracing.span("eval.copy"):
                    entry[2].copy_(inp)
            self._graphs[key] = entry  # the most recently used last
            graph, tally, _, out = entry
            with tracing.span("eval.launch"):
                graph.replay()
            tally.add()
            self.replays += 1
            return out
