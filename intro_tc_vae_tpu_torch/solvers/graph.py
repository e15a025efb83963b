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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from intro_tc_vae_tpu_torch.ops import launch_counts

WARMUP_STEPS = 3  # eager steps before the capture


class CudaGraph:
    """``torch.cuda.CUDAGraph`` with its capture context, the interface
    ``GraphedStep`` takes (a test passes another)."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self):
        return torch.cuda.graph(self.graph)

    def replay(self) -> None:
        self.graph.replay()


class GraphedStep:
    """``step`` (state, batch, noise) -> metrics dict as a captured graph;
    a call returns (metric names, float32 [n] metrics). The returned
    tensor of a replay is the graph's static output: the next call
    overwrites it, so the caller copies it first."""

    def __init__(self, step: Callable, noise_keys: Sequence[str], zdim: int,
                 graph_factory: Callable = CudaGraph, warmup: int = WARMUP_STEPS):
        self.step = step
        self.noise_keys = tuple(noise_keys)
        self.zdim = zdim
        self.graph_factory = graph_factory
        self.warmup = warmup
        self.warm = 0                 # eager steps taken
        self.captures = 0
        self.names: tuple = ()
        self.graph = None
        self.tally: Optional[launch_counts.Tally] = None
        self._batch: Optional[torch.Tensor] = None
        self._noise: dict = {}
        self._out: Optional[torch.Tensor] = None
        self._signature = None

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
        """The step on the static buffers, its metrics stacked: [n]."""
        from intro_tc_vae_tpu_torch.solvers.base import normalize_input

        metrics = self.step(state, normalize_input(self._batch), self._noise)
        self.names = tuple(metrics)
        return torch.stack([v.detach().float().reshape(()) for v in metrics.values()])

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
        self.fill(state, batch, noise)
        if self.graph is not None and self.signature(state) != self._signature:
            self.drop()
        if self.graph is None:
            if self.warm < self.warmup or not self._initialized(state):
                self.warm += 1
                out = self.body(state)  # sets self.names
                return self.names, out
            self._capture(state)
        self.graph.replay()
        self.tally.add()
        state.step += 1
        return self.names, self._out

