"""Profile the port's train step and attribute its device and host time.

Counterpart of ``analysis/profile_step.py`` (the JAX package's), with its
arguments and ``--graph {0,1}``:

    python -m intro_tc_vae_tpu_torch.analysis.profile_step --solver intro_tc \\
        --batch 64 --image-size 64 --arch conv --z-dim 128 --steps 5 --graph 1

It builds the solver on a ``Synthetic`` dataset (Adam 2e-4, the flagship's
betas, ``--tc-impl`` / ``--conv-impl`` as given), takes warm-up steps,
times ``--wall-iters`` untraced steps on the host clock, then runs
``torch.profiler`` over ``--steps`` steady steps and prints a table and,
last, one JSON line:

* device time per step by category. A kernel's category comes from the
  operation that launched it: the CPU op or ``record_function`` range
  around the launch call that the kernel's correlation id names, never
  from the kernel's own name (the JAX script's comment at
  analysis/profile_step.py:59-64 records what naming by fusion got
  wrong). Categories: cuDNN conv forward, dgrad and wgrad (inside a
  convolution's backward op the two are told apart by cuDNN's kernel
  names, as is the layout transpose it inserts, which counts as a copy),
  each hand kernel by its ``LAUNCHES`` name (the wrappers' ``itcvae::
  launch:<name>`` ranges), matrix products, reductions, random draws, the
  optimizer (``Optimizer.step``), copies and layout transposes, and
  BatchNorm / elementwise for the rest;
* the top operations and kernels;
* the host's side: host ms per step (the ``train_step`` calls), wall ms
  per step, the host time in operations by the same categories (the
  outermost aten ops; the rest of a step's host time is Python and
  autograd's bookkeeping), kernel launches per step (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ``cudaGraphLaunch`` and their variants), the host
  time of the TC and conv wrappers (their ``itcvae::`` ranges), and the
  device's idle share, 1 - busy / wall over the profiled window.

With ``--graph 1`` the step is one CUDA graph (``solvers/graph.py``): its
replays' kernels correlate with ``cudaGraphLaunch`` alone, so they take
the categories of an eager run of the same body (the graph's third
warm-up step, profiled apart), matched kernel by kernel in launch order,
one replay (``cudaGraphLaunch``) at a time (``difflib``; an unmatched
kernel counts as ``unattributed``). Warm-up
and capture run outside the profiled window. Runs on the card unless
``--device cpu`` (a CPU trace has no kernels: its leaf operations stand in
for them, and it counts no launches).

The HLO roofline half of the JAX script (``parse_conv_rooflines``) reads
XLA's HLO and has no counterpart here; ``chip_smoke.py::bound`` holds the
hand kernels to theirs.
"""

from __future__ import annotations

import argparse
import collections
import difflib
import json
import os
import tempfile
import time

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_RANGE = "itcvae::train_step"
HAND = "itcvae::launch:"
CONV_FWD = {"aten::cudnn_convolution", "aten::_convolution", "aten::convolution",
            "aten::conv2d", "aten::cudnn_convolution_relu"}
CONV_BWD = {"aten::convolution_backward", "aten::cudnn_convolution_backward"}
MATMUL = {"aten::mm", "aten::addmm", "aten::bmm", "aten::matmul", "aten::linear",
          "aten::baddbmm"}
REDUCTIONS = {"aten::sum", "aten::mean", "aten::var", "aten::std", "aten::norm",
              "aten::linalg_vector_norm", "aten::logsumexp", "aten::max", "aten::min",
              "aten::amax", "aten::amin", "aten::prod", "aten::cumsum", "aten::_foreach_norm",
              "aten::var_mean", "aten::argmax", "aten::all", "aten::any"}
RANDOM = {"aten::normal_", "aten::randn", "aten::uniform_", "aten::rand"}
COPIES = {"aten::copy_", "aten::to", "aten::_to_copy", "aten::clone", "aten::contiguous",
          "aten::cat", "aten::stack", "aten::index_select", "aten::index", "aten::flip",
          "aten::fill_", "aten::zero_", "aten::zeros", "aten::zeros_like", "aten::ones",
          "aten::ones_like", "aten::full", "aten::full_like", "aten::constant_pad_nd",
          "aten::pad", "aten::gather", "aten::repeat_interleave", "aten::_foreach_copy_",
          "aten::pixel_unshuffle", "aten::pixel_shuffle", "aten::narrow_copy"}


# ---------------------------------------------------------------------------
# the analyzer: chrome-trace events -> attribution
# ---------------------------------------------------------------------------

def category(ops: list, kernel: str = "") -> str:
    """The category of work launched inside ``ops`` (the enclosing CPU ops
    and ranges, outermost first); ``kernel`` splits a convolution's
    backward (cuDNN launches dgrad and wgrad under one op) and tells the
    layout transposes a convolution inserts."""
    for name in reversed(ops):
        if name.startswith(HAND):
            return "hand: " + name[len(HAND):]
    if any(name.startswith("Optimizer.step") for name in ops):
        return "optimizer"
    k = kernel.lower()
    for name in reversed(ops):
        if name in CONV_FWD or name in CONV_BWD:
            if "nchwtonhwc" in k or "nhwctonchw" in k or "transpose" in k:
                return "copies and layout transposes"
            if name in CONV_FWD:
                return "cuDNN conv fwd"
            if "dgrad" in k:
                return "cuDNN conv dgrad"
            if "wgrad" in k:
                return "cuDNN conv wgrad"
            return "cuDNN conv bwd (other)"
        for cat, names in (("matrix products", MATMUL), ("reductions", REDUCTIONS),
                           ("random", RANDOM), ("copies and layout transposes", COPIES)):
            if name in names:
                return cat
    if kernel.startswith("Memcpy") or kernel.startswith("Memset"):
        return "copies and layout transposes"
    return "BatchNorm / elementwise"


def _innermost_op(ops: list) -> str:
    for name in reversed(ops):
        if name.startswith("aten::") or name.startswith(HAND):
            return name
    return ops[-1] if ops else "(none)"


class _Spans:
    """The CPU ops and ranges of each thread, to find what encloses a
    moment of that thread (spans of one thread nest)."""

    def __init__(self, events: list):
        by_thread = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
                by_thread[(e["pid"], e["tid"])].append((e["ts"], -e["dur"], e["name"]))
        self._spans = {k: sorted(v) for k, v in by_thread.items()}

    def enclosing(self, queries: list) -> dict:
        """{key: names of the spans open at ts, outermost first} for each
        (pid, tid, ts, key) of ``queries``: one sweep per thread."""
        out = {}
        by_thread = collections.defaultdict(list)
        for pid, tid, ts, key in queries:
            by_thread[(pid, tid)].append((ts, key))
        for thread, moments in by_thread.items():
            spans, i, stack = self._spans.get(thread, []), 0, []
            for ts, key in sorted(moments, key=lambda m: m[0]):
                while i < len(spans) and spans[i][0] <= ts:
                    start, neg_dur, name = spans[i]
                    while stack and stack[-1][0] < start:
                        stack.pop()
                    stack.append((start - neg_dur, name))
                    i += 1
                while stack and stack[-1][0] < ts:
                    stack.pop()
                out[key] = [name for _, name in stack]
        return out

    def leaves(self) -> list:
        """(pid, tid, ts, dur, name) of every CPU op that holds no other."""
        out = []
        for (pid, tid), spans in self._spans.items():
            for i, (start, neg_dur, name) in enumerate(spans):
                nxt = spans[i + 1] if i + 1 < len(spans) else None
                if name.startswith("aten::") and not (nxt and nxt[0] < start - neg_dur):
                    out.append((pid, tid, start, -neg_dur, name))
        return out


def work_items(events: list) -> list:
    """One dict per kernel, copy or set the card ran (per leaf CPU op on a
    trace without any): name, us, ts, stream, category, op and whether a
    graph launch issued it."""
    spans = _Spans(events)
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    calls = [(i, runtime.get(e.get("args", {}).get("correlation"))) for i, e in enumerate(device)]
    stacks = spans.enclosing([(c["pid"], c["tid"], c["ts"], i) for i, c in calls if c])
    items = []
    for (i, call), e in zip(calls, device):
        ops = stacks.get(i, [])
        items.append({"name": e["name"], "us": float(e["dur"]), "ts": float(e["ts"]),
                      "stream": e.get("args", {}).get("stream"),
                      "graph": bool(call) and call["name"] == "cudaGraphLaunch",
                      "launch": e.get("args", {}).get("correlation"),
                      "category": category(ops, e["name"]), "op": _innermost_op(ops)})
    if not items:  # a CPU trace: its leaf operations did the work
        leaves = spans.leaves()
        stacks = spans.enclosing([(pid, tid, ts + dur / 2, j)
                                  for j, (pid, tid, ts, dur, _) in enumerate(leaves)])
        for j, (_, _, ts, dur, name) in enumerate(leaves):
            items.append({"name": name, "us": float(dur), "ts": float(ts), "stream": None,
                          "graph": False, "launch": None, "category": category(stacks[j]),
                          "op": name})
    return sorted(items, key=lambda it: it["ts"])


def reference_kernels(events: list) -> list:
    """An eager run of a graph's body (``GraphedStep``'s third warm-up
    step): [(kernel name, category, op)] of the stream that ran the most
    kernels, in launch order (the metric ring's copies after the body
    match no replayed kernel and stay unused)."""
    items = [it for it in work_items(events) if it["stream"] is not None]
    if not items:
        return []
    stream = collections.Counter(it["stream"] for it in items).most_common(1)[0][0]
    return [(it["name"], it["category"], it["op"]) for it in items if it["stream"] == stream]


def attribute_graph(items: list, reference: list) -> int:
    """Give each replayed kernel (``graph``) the category and op of the
    reference kernel it matches in launch order, replay by replay (the
    kernels of one ``cudaGraphLaunch``); returns how many stayed
    unattributed."""
    replays: dict = {}
    for it in items:
        if it["graph"]:
            replays.setdefault(it["launch"], []).append(it)
    names = [r[0] for r in reference]
    unmatched = 0
    for chunk in replays.values():
        matcher = difflib.SequenceMatcher(None, names, [it["name"] for it in chunk],
                                          autojunk=False)
        matched = set()
        for block in matcher.get_matching_blocks():
            for j in range(block.size):
                it = chunk[block.b + j]
                _, it["category"], it["op"] = reference[block.a + j]
                matched.add(block.b + j)
        for j, it in enumerate(chunk):
            if j not in matched:
                it["category"], it["op"] = "unattributed", "(graph)"
                unmatched += 1
    return unmatched


def host_categories(events: list) -> dict:
    """Host microseconds of the outermost aten ops (no aten op around
    them), by the category ``category`` gives them; what the host spends
    outside any (Python, autograd's bookkeeping) is the step's host time
    less their sum."""
    spans = _Spans(events)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    stacks = spans.enclosing([(e["pid"], e["tid"], e["ts"], i) for i, e in enumerate(ops)])
    out = collections.Counter()
    for i, e in enumerate(ops):
        around = stacks.get(i, [])
        inside = around[:around.index(e["name"])] if e["name"] in around else around
        if any(name.startswith("aten::") for name in inside):
            continue  # counted with the op around it
        out[category(around)] += e["dur"]
    return out


def _busy_us(items: list) -> float:
    total, end = 0.0, None
    for it in sorted(items, key=lambda i: i["ts"]):
        a, b = it["ts"], it["ts"] + it["us"]
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def analyze(events: list, steps: int, reference: list | None = None) -> dict:
    """Per-step attribution of a trace of ``steps`` steps (see the module
    docstring); ``reference``: ``reference_kernels`` of an eager run of a
    graphed step's body."""
    items = work_items(events)
    unattributed = attribute_graph(items, reference) if reference else 0
    device = any(e.get("cat") in DEVICE_CATS for e in events)
    per = 1e3 * steps  # us over the steps -> ms a step

    cats, ops, kernels, hand = (collections.Counter() for _ in range(4))
    for it in items:
        cats[it["category"]] += it["us"]
        ops[it["op"]] += it["us"]
        kernels[it["name"]] += it["us"]
        if it["category"].startswith("hand: "):
            hand[it["category"][len("hand: "):]] += it["us"]
    total = sum(cats.values())
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    step_ranges = [e for e in ranges if e["name"] == STEP_RANGE]
    launches = collections.Counter(e["name"] for e in events if e.get("ph") == "X"
                                   and e.get("cat") in ("cuda_runtime", "cuda_driver")
                                   and e["name"] in LAUNCH_CALLS)
    wrappers = collections.Counter()
    for e in ranges:
        if e["name"].startswith("itcvae::") and e["name"] != STEP_RANGE:
            wrappers[e["name"][len("itcvae::"):]] += e["dur"]
    out = {
        "device_kind": "cuda" if device else "cpu",
        "steps": steps,
        "busy_ms_step": _busy_us(items) / per,
        "work_ms_step": total / per,
        "categories": {k: v / per for k, v in cats.most_common()},
        "hand_kernels": {k: v / per for k, v in hand.most_common()},
        "top_ops": [[k, v / per] for k, v in ops.most_common(12)],
        "top_kernels": [[k, v / per] for k, v in kernels.most_common(12)],
        "work_items_per_step": len(items) / steps,
        "unattributed_per_step": unattributed / steps,
        "launches_per_step": {k: launches[k] / steps for k in LAUNCH_CALLS},
        "wrapper_host_ms_step": {k: v / per for k, v in sorted(wrappers.items())},
        "host_op_ms_step": {k: v / per for k, v in host_categories(events).most_common()},
        "host_ms_step": sum(e["dur"] for e in step_ranges) / per if step_ranges else None,
    }
    if step_ranges:
        start = min(e["ts"] for e in step_ranges)
        end = max([e["ts"] + e["dur"] for e in step_ranges]
                  + [it["ts"] + it["us"] for it in items])
        out["window_ms_step"] = (end - start) / per
        out["idle_share"] = 1.0 - _busy_us(items) / (end - start) if device else None
    return out


def load_trace(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def trace_of(prof) -> list:
    """A finished ``torch.profiler.profile``'s events (its chrome trace)."""
    with tempfile.TemporaryDirectory(prefix="itcvae-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return load_trace(path)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

CHANNELS = {64: (64, 128, 256, 512), 128: (64, 128, 256, 512, 512),
            256: (64, 128, 256, 512, 512, 512), 32: (16, 32), 16: (8, 16)}


def build(solver_name: str, batch: int, image_size: int, arch: str, zdim: int,
          precision: str, tc_impl: str, conv_impl: str, graph: bool, device):
    """(solver, state, batch) of the JAX script's set-up on ``device``."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    torch.manual_seed(0)
    ds = Synthetic(image_size=image_size, cdim=3, sizes=(4, 5, 8, 8))
    kw = dict(arch=arch, cdim=3, zdim=zdim, channels=CHANNELS[image_size],
              image_size=image_size, conv_impl=conv_impl,
              compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32)
    encoder, decoder = Encoder(**kw).to(device), Decoder(**kw).to(device)
    solver = make_solver(
        solver_name, dataset=ds, encoder=encoder, decoder=decoder, batch_size=batch,
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, tc_impl=tc_impl, graph=graph)
    state = solver.init_state(0)
    state.model.train()
    x = torch.from_numpy(ds.get_batch(np.arange(batch) % len(ds)).transpose(0, 3, 1, 2).copy())
    return solver, state, x.to(device)


def profile_step(solver_name: str = "intro_tc", batch: int = 64, image_size: int = 64,
                 arch: str = "conv", zdim: int = 128, steps: int = 5,
                 precision: str = "bf16", wall_iters: int = 30, graph: bool = True,
                 tc_impl: str = "pallas", conv_impl: str = "pallas",
                 device: str = "cuda") -> dict:
    """Build, warm up, time ``wall_iters`` steps on the host clock, profile
    ``steps`` steps; returns ``analyze``'s dict with the wall figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if graph and not cuda:
        raise ValueError("--graph 1 needs the card (a CUDA graph)")
    solver, state, x = build(solver_name, batch, image_size, arch, zdim, precision,
                             tc_impl, conv_impl, graph, dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def step():
        with record_function(STEP_RANGE):
            solver.train_step(state, x)

    def drain():
        sync()
        solver.metric_ring.drain()

    reference = None
    if graph:  # two warm-up steps, the third profiled as the reference, the capture
        step()
        step()
        drain()
        with profile(activities=activities) as prof:
            step()
            sync()
        reference = reference_kernels(trace_of(prof))
        step()
    else:
        for _ in range(4):
            step()
    drain()

    host = wall = None
    if wall_iters:
        t0 = time.perf_counter()
        spent = 0.0
        for _ in range(wall_iters):
            t = time.perf_counter()
            step()
            spent += time.perf_counter() - t
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / wall_iters
        host = spent * 1e3 / wall_iters
        drain()

    with profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        sync()
    out = analyze(trace_of(prof), steps, reference)
    drain()
    captures = solver.graphed.captures if graph else 0
    if graph and captures != 1:
        raise RuntimeError(f"{captures} captures, expected 1 (outside the profiled window)")
    out.update(graph=bool(graph), captures=captures, reference_kernels=len(reference or []),
               wall_ms_step=wall, host_ms_step_untraced=host,
               config=dict(solver=solver_name, batch=batch, image_size=image_size, arch=arch,
                           z_dim=zdim, precision=precision, tc_impl=tc_impl,
                           conv_impl=conv_impl, device=str(dev)))
    if cuda:
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def print_table(r: dict) -> None:
    arm = "graphed" if r["graph"] else "eager"
    print(f"profile_step ({arm}, {r['device_kind']}): busy {r['busy_ms_step']:.3f} ms/step, "
          f"work {r['work_ms_step']:.3f} ms/step over {r['steps']} steps")
    if r.get("wall_ms_step") is not None:
        print(f"  wall {r['wall_ms_step']:.3f} ms/step, host in train_step "
              f"{r['host_ms_step_untraced']:.3f} ms/step (untraced)")
    if r.get("idle_share") is not None:
        print(f"  traced: host {r['host_ms_step']:.3f} ms/step, window "
              f"{r['window_ms_step']:.3f} ms/step, device idle share {r['idle_share']:.4f}")
    print("  launches per step " + json.dumps(r["launches_per_step"]))
    for k, v in r["categories"].items():
        print(f"  {k:34s} {v:9.4f} ms/step  {100 * v / max(r['work_ms_step'], 1e-12):5.1f}%")
    print("  hand kernels: " + json.dumps({k: round(v, 5) for k, v in r["hand_kernels"].items()}))
    print("  host ms/step in ops by category: "
          + json.dumps({k: round(v, 4) for k, v in r["host_op_ms_step"].items()}))
    print("  wrappers' host ms/step: "
          + json.dumps({k: round(v, 5) for k, v in r["wrapper_host_ms_step"].items()}))
    print("  top ops:")
    for name, ms in r["top_ops"]:
        print(f"    {ms:9.4f} ms  {name[:90]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="intro_tc")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--arch", default="conv")
    ap.add_argument("--z-dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--wall-iters", type=int, default=30,
                    help="untraced steps timed on the host clock (0 disables)")
    ap.add_argument("--graph", type=int, choices=(0, 1), default=1,
                    help="1: the step as one CUDA graph, as the trainer runs it on a card")
    ap.add_argument("--tc-impl", default="pallas")
    ap.add_argument("--conv-impl", default="pallas")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    r = profile_step(a.solver, a.batch, a.image_size, a.arch, a.z_dim, a.steps, a.precision,
                     a.wall_iters, bool(a.graph), a.tc_impl, a.conv_impl, a.device)
    print_table(r)
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
