"""PyTorch port: the harnesses of ``intro_tc_vae_tpu_torch/analysis/``.

* ``profile_step``'s analyzer on a CPU ``torch.profiler`` trace of a tiny
  ``vae`` step (its leaf operations stand in for kernels there): the
  categories sum to the total, work items are counted and no launch is.
* The analyzer on a hand-written CUDA trace: each kernel takes the
  category of the operation whose launch call its correlation id names
  (a convolution's backward split into dgrad and wgrad, the hand kernels
  by their ``itcvae::launch:`` ranges, the optimizer's update), launches
  per step, the wrappers' host time, the idle share, and a graph's
  replayed kernels attributed from an eager reference in launch order,
  one graph launch at a time.
* ``bench_system``, ``bench_loader`` and ``profile_step`` as commands in a
  subprocess at tiny sizes on the CPU: exit code 0, the JSON line's keys,
  and no ``jax`` in ``sys.modules``.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from intro_tc_vae_tpu_torch.analysis import profile_step as ps
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_analyzer_on_a_cpu_trace_of_a_tiny_vae_step():
    from torch.profiler import ProfilerActivity, profile, record_function

    solver, state, x = ps.build("vae", 4, 16, "conv", 8, "fp32", "xla", "xla", False,
                                torch.device("cpu"))
    solver.train_step(state, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(ps.STEP_RANGE):
                solver.train_step(state, x)
    r = ps.analyze(ps.trace_of(prof), 2)
    assert r["device_kind"] == "cpu" and r["steps"] == 2
    assert r["work_items_per_step"] > 100
    assert math.isclose(sum(r["categories"].values()), r["work_ms_step"], rel_tol=1e-9)
    assert r["work_ms_step"] > 0 and r["host_ms_step"] > 0
    assert {"optimizer", "cuDNN conv fwd", "BatchNorm / elementwise"} <= set(r["categories"])
    assert all(n == 0 for n in r["launches_per_step"].values())
    assert r["idle_share"] is None and r["unattributed_per_step"] == 0
    assert 0 < sum(r["host_op_ms_step"].values()) <= r["host_ms_step"]


def _span(name, ts, dur, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, ts, name="cudaLaunchKernel", tid=1):
    return {**_span(name, ts, 1, tid, "cuda_runtime"), "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "args": {"correlation": corr, "stream": stream}}


def _cuda_trace():
    """One step: a cuDNN forward, a backward with dgrad, wgrad and a
    layout transpose, a hand kernel, a sum, Adam, on the autograd thread
    where autograd runs; 100 us of host, kernels busy 60 us of 140."""
    ev = [
        _span(ps.STEP_RANGE, 0, 100, cat="user_annotation"),
        _span("aten::cudnn_convolution", 5, 10), _launch(1, 6),
        _span("itcvae::conv3x3_fwd", 20, 10, cat="user_annotation"),
        _span("itcvae::launch:conv3x3_fwd_wgmma", 22, 6, cat="user_annotation"),
        _launch(2, 23),
        _span("aten::convolution_backward", 40, 20, tid=2), _launch(3, 41, tid=2),
        _launch(4, 45, "cuLaunchKernel", tid=2), _launch(5, 50, tid=2),
        _span("aten::sum", 62, 5, tid=2), _launch(6, 63, tid=2),
        _span("Optimizer.step#Adam.step", 70, 20, cat="user_annotation"),
        _span("aten::_foreach_add_", 71, 5), _launch(7, 72),
        _kernel("cudnn_fprop", 1, 10, 10), _kernel("conv3x3_fwd_wgmma_kernel", 2, 30, 10),
        _kernel("sm90_xmma_dgrad_kernel", 3, 60, 10),
        _kernel("sm90_xmma_wgrad_kernel", 4, 70, 10),
        _kernel("nhwcToNchwKernel", 5, 80, 5), _kernel("reduce_kernel", 6, 90, 5),
        _kernel("multi_tensor_apply_kernel", 7, 130, 10),
    ]
    return ev


def test_analyzer_attributes_kernels_by_their_launching_op():
    r = ps.analyze(_cuda_trace(), 1)
    assert r["device_kind"] == "cuda"
    assert r["categories"] == pytest.approx({
        "cuDNN conv fwd": 0.01, "hand: conv3x3_fwd_wgmma": 0.01, "cuDNN conv dgrad": 0.01,
        "cuDNN conv wgrad": 0.01, "copies and layout transposes": 0.005,
        "reductions": 0.005, "optimizer": 0.01})
    assert r["hand_kernels"] == pytest.approx({"conv3x3_fwd_wgmma": 0.01})
    assert r["launches_per_step"]["cudaLaunchKernel"] == 6
    assert r["launches_per_step"]["cuLaunchKernel"] == 1
    assert r["wrapper_host_ms_step"] == pytest.approx({
        "conv3x3_fwd": 0.01, "launch:conv3x3_fwd_wgmma": 0.006})
    assert r["host_ms_step"] == pytest.approx(0.1)
    assert r["busy_ms_step"] == pytest.approx(0.06)
    assert r["window_ms_step"] == pytest.approx(0.14)
    assert r["idle_share"] == pytest.approx(1 - 60 / 140)


def test_analyzer_attributes_a_graphs_replays_from_the_eager_reference():
    reference = ps.reference_kernels(_cuda_trace())
    assert [k for k, _, _ in reference][:2] == ["cudnn_fprop", "conv3x3_fwd_wgmma_kernel"]
    names = [k for k, _, _ in reference]
    events = [_span(ps.STEP_RANGE, 0, 20, cat="user_annotation")]
    for step, corr in enumerate((100, 200)):  # two replays, one graph launch each
        events.append(_launch(corr, 1 + 10 * step, "cudaGraphLaunch"))
        replayed = names if step == 0 else names[:3] + ["extra_kernel"] + names[3:]
        for i, name in enumerate(replayed):
            events.append(_kernel(name, corr, 1000 * (step + 1) + 10 * i, 4))
    r = ps.analyze(events, 2, reference)
    assert r["launches_per_step"]["cudaGraphLaunch"] == 1
    assert r["unattributed_per_step"] == 0.5
    assert r["categories"]["hand: conv3x3_fwd_wgmma"] == pytest.approx(0.004)
    assert r["categories"]["cuDNN conv wgrad"] == pytest.approx(0.004)
    assert r["categories"]["unattributed"] == pytest.approx(0.002)


def test_graph_replays_are_matched_one_graph_launch_at_a_time():
    """The eager reference also holds the kernels after the body (the
    metric ring's copies, on the same stream since the warm-up runs on the
    current one): each replay, the kernels of one ``cudaGraphLaunch``, is
    matched on its own, so the reference's extra kernels shift nothing."""
    body = ["k%d" % i for i in range(7)]
    reference = [(name, f"cat {name}", "aten::op") for name in body + ["copy_", "Memcpy DtoH"]]
    events = [_span(ps.STEP_RANGE, 0, 40, cat="user_annotation")]
    for step, corr in enumerate((100, 200, 300)):
        events.append(_launch(corr, 1 + 10 * step, "cudaGraphLaunch"))
        for i, name in enumerate(body):
            events.append(_kernel(name, corr, 1000 * (step + 1) + 10 * i, 2))
    r = ps.analyze(events, 3, reference)
    assert r["unattributed_per_step"] == 0
    assert r["categories"] == pytest.approx({f"cat {name}": 0.002 for name in body})


NO_JAX = ("import runpy, sys; sys.argv = ['m'] + sys.argv[1:]; "
          "runpy.run_module('intro_tc_vae_tpu_torch.analysis.{name}', run_name='__main__'); "
          "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
          "or m.startswith('intro_tc_vae_tpu.') or m == 'intro_tc_vae_tpu'); "
          "assert not bad, bad")


def _command(name: str, *args) -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", NO_JAX.format(name=name), *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bench_system_command():
    r = _command("bench_system", "uint8", "cache", "auto:2", "--device", "cpu",
                 "--images", "16", "--steps-per-epoch", "2", "--epochs", "2",
                 "--image-size", "16", "--graph", "0", "--tensorboard", "0")
    assert r["metric"] == "bench_system" and r["batch"] == 8 and r["card"] is None
    assert set(r["arms"]) == {"uint8", "cache", "auto:2"}
    for arm in r["arms"].values():
        assert set(arm) == {"eager"}
        e = arm["eager"]
        assert set(e) == {"img_s", "img_s_epochs_median", "epoch_img_s", "steps"}
        assert e["steps"] == 4 and len(e["epoch_img_s"]) == 2 and e["img_s_epochs_median"] > 0


def test_bench_loader_command():
    r = _command("bench_loader", "--device", "cpu", "--seconds", "0.2", "--batch", "8")
    assert r["metric"] == "loader_images_per_sec" and r["device"] == "cpu"
    for key in ("ukiyo_cached", "ukiyo_uncached", "synthetic", "loader_ukiyo_cached"):
        assert r[key] > 0, key


def test_profile_step_command():
    r = _command("profile_step", "--device", "cpu", "--graph", "0", "--solver", "vae",
                 "--batch", "4", "--image-size", "16", "--z-dim", "8", "--steps", "2",
                 "--wall-iters", "2", "--precision", "fp32", "--tc-impl", "xla",
                 "--conv-impl", "xla")
    assert r["graph"] is False and r["device_kind"] == "cpu" and r["captures"] == 0
    assert r["wall_ms_step"] > 0 and r["host_ms_step_untraced"] > 0
    assert math.isclose(sum(r["categories"].values()), r["work_ms_step"], rel_tol=1e-9)
