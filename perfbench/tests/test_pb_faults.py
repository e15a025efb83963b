"""The comparison that decides ``correct`` must fail a broken run: a run
of the harness past its look for a card, at synthetic_small widths on the
CPU, with the timed path broken underneath (``control.planted``), judged
by the cell's own limits; and the control, the reference in float8 in the
program's place. The train runs here go through the graphed step over a
stand-in graph that reruns the step's body (``graphed_on_the_cpu``), so
that a fault in the replays alone shows. The same faults on the card,
through real CUDA graphs: test_pb_cuda.py."""

import contextlib

import pytest
import torch

from perfbench.control import invert_one, planted
from perfbench.modes import sample as sample_mode
from perfbench.modes import train as train_mode
from perfbench.run import judge


class RerunGraph:
    """A stand-in for a CUDA graph on the CPU (``graphed_on_the_cpu``):
    its capture runs nothing of its own, and its replay runs the graphed
    step's body again on the static buffers (``rerun``)."""

    def __init__(self):
        self.rerun = None

    def capture(self):
        return contextlib.nullcontext()

    def replay(self):
        self.rerun()


def graphed_step_class():
    from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep

    class RerunGraphedStep(GraphedStep):
        """``GraphedStep`` over ``RerunGraph``: the capture's body runs
        eagerly, and every state tensor it changed is put back, since a
        capture runs no step; a replay runs the body on the static batch
        and noise and copies its metrics into the capture's output."""

        def __init__(self, step, noise_keys, zdim):
            super().__init__(step, noise_keys, zdim, graph_factory=RerunGraph)

        def _capture(self, state):
            kept = [t.detach().clone() for t in self._tensors(state)]
            super()._capture(state)
            with torch.no_grad():
                for t, v in zip(self._tensors(state), kept):
                    t.copy_(v)
            self.graph.rerun = lambda: self._out.copy_(self.body(state))

    return RerunGraphedStep


@contextlib.contextmanager
def graphed_on_the_cpu():
    """``train.setup`` on the CPU with its step graphed over
    ``RerunGraph``: eager warm-up, capture and replays as on the card."""
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.solvers import base

    saved = train.graph_step, base.GraphedStep
    train.graph_step = lambda *args, **kwargs: True
    base.GraphedStep = graphed_step_class()
    try:
        yield
    finally:
        train.graph_step, base.GraphedStep = saved


def train_run(cell, seed, device="cpu", fault=None, stand_in=None):
    graphed = graphed_on_the_cpu() if torch.device(device).type == "cpu" else contextlib.nullcontext()
    with graphed, planted(fault) if fault else contextlib.nullcontext():
        s = train_mode.build(cell, seed, device)
        train_mode.window(s, 0.2, trace=False)
    train_mode.free(s)
    checks = train_mode.check(s, stand_in)
    return judge(checks, cell.limits)[0], checks


def sample_run(cell, seed, device="cpu", alter=False, stand_in=None):
    s = sample_mode.build(cell, seed, device)
    if alter:
        s.serve = invert_one(s.serve)
    sample_mode.window(s, 0.2, trace=False)
    sample_mode.free(s)
    checks = sample_mode.check(s, stand_in)
    return judge(checks, cell.limits)[0], checks


@pytest.mark.parametrize("workload", ["itc64.train", "itc128.train"])
def test_train_faults_fail(small, workload):
    cell = small(workload)
    assert train_run(cell, 21)[0]
    for fault in ("unchanged", "half_batch", "stale_batch"):
        ok, checks = train_run(cell, 21, fault=fault)
        assert not ok, (fault, checks)


@pytest.mark.parametrize("workload", ["itc64.train", "itc128.train"])
def test_train_control_fails(small, workload):
    ok, checks = train_run(small(workload, batch=16), 22, stand_in="fp8")
    assert not ok, checks


@pytest.mark.parametrize("workload", ["itc64.sample", "itc128.sample"])
def test_sample_fault_and_control_fail(small, workload):
    cell = small(workload)
    assert sample_run(cell, 23)[0]
    assert not sample_run(cell, 23, alter=True)[0]
    ok, checks = sample_run(cell, 23, stand_in="fp8")
    assert not ok, checks
