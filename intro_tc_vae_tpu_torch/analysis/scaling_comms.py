"""Cross-rank traffic audit: what one parallel train step's collectives move.

Counterpart of ``analysis/scaling_comms.py`` (the JAX package's), with its
``--tiny`` and the shape of its JSON and markdown table. The JAX script
compiles the step over a virtual mesh and parses the optimized HLO for
collectives; the port issues its collectives itself, so it counts what
they move (``parallel/comm_counts.py``: calls and payload bytes, by kind
and by site) over one step of each phase, on ``--ranks`` R processes that
join a ``gloo`` group (on one card they share it, as ``chip_smoke.py``'s
phases 7 and 14 do):

* ``dp``: the intro_tc step data-parallel over R ranks, ``tc_impl``
  ``xla``;
* ``dp_gathered_tc``: the same with ``tc_impl`` ``pallas`` (the gathered
  TC kernels on the card). The port's TC always gathers the mu bank under
  a data group, whatever ``tc_impl``, so both phases move the same bytes
  (JAX's ``dp8`` lets GSPMD place the plain TC's collectives);
* ``tp2_dp``: ``model_parallel`` 2 over the R ranks (TP2 x DP R/2), the
  wide leaves cut at ``min_dim`` 8 as in JAX.

Shapes: the flagship's (64 px, channels 64-128-256-512, z 128, batch 64)
or with ``--tiny`` JAX's CI shapes (32 px, channels 16-32, z 16, batch
2 R); fp32. Each phase also checks its counts against the closed forms of
``expected_bytes``: the gradient average moves every gradient it averages
once a step (4 bytes a float32 element: the whole parameters under a data
group, the replicated ones across the model axis), the metric average one
float64 a metric, and each of the step's 5 TC calls under a data group
gathers the global batch's mu bank (float32 [GB, z]) and reduce-scatters
this rank's rows of its gradient; a phase that disagrees fails (exit 1).

    python -m intro_tc_vae_tpu_torch.analysis.scaling_comms            # flagship shapes, 2 ranks
    python -m intro_tc_vae_tpu_torch.analysis.scaling_comms --tiny --ranks 4 --device cpu

Writes ``--out`` (default ``docs/scaling_comms_torch.json``; the JAX
script's ``docs/scaling_comms.json`` is its own) and prints JAX's table.
The ranks run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = (("dp", 1, "xla"), ("dp_gathered_tc", 1, "pallas"), ("tp2_dp", 2, "xla"))
MIN_DIM = 8  # the JAX script's min_dim for its tensor-parallel phase
TIMEOUT = 600.0


def shapes(tiny: bool, ranks: int) -> dict:
    if tiny:
        return dict(image_size=32, channels=(16, 32), zdim=16, batch=2 * ranks)
    return dict(image_size=64, channels=(64, 128, 256, 512), zdim=128, batch=64)


def expected_bytes(state, mesh, n_metrics: int, tc_calls: int, zdim: int,
                   global_batch: int) -> dict:
    """{site: payload bytes} one step must move at the sites with a
    closed form (``comm_counts`` names)."""
    sharded = replicated = 0
    for p in state.model.parameters():
        n = p.numel() * p.element_size()
        if getattr(p, "tp", None) is None:
            replicated += n
        else:
            sharded += n
    model = mesh.model.size if mesh.model is not None else 1
    out = {"average_grads": (sharded if mesh.size > 1 else 0)
           + (replicated if mesh.size * model > 1 else 0)}
    if mesh.size > 1:
        out["all_reduce_mean_"] = 8 * n_metrics
        out["all_gather_rows"] = tc_calls * 4 * global_batch * zdim
        out["all_gather_rows backward"] = tc_calls * 4 * (global_batch // mesh.size) * zdim
    return out


def one_step(phase: str, model_parallel: int, tc_impl: str, shape: dict, device) -> dict:
    """One intro_tc step of ``phase`` on this rank: the collectives'
    counts by kind and by site, the parameter bytes (whole and this
    rank's) and the closed forms."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch import ops
    from intro_tc_vae_tpu_torch.data import Synthetic
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.parallel import (
        batch_sharding,
        comm_counts,
        make_mesh,
        replicate_state,
        shard_state,
    )
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    mesh = make_mesh(model_parallel=model_parallel, device=device)
    torch.manual_seed(0)
    ds = Synthetic(image_size=shape["image_size"], cdim=3, sizes=(4, 5, 8, 8))
    kw = dict(arch="conv", cdim=3, zdim=shape["zdim"], channels=shape["channels"],
              image_size=shape["image_size"], compute_dtype=torch.float32)
    enc, dec = Encoder(**kw).to(device), Decoder(**kw).to(device)
    whole = sum(p.numel() * p.element_size() for p in [*enc.parameters(), *dec.parameters()])
    solver = make_solver(
        "intro_tc", dataset=ds, encoder=enc, decoder=dec, batch_size=shape["batch"],
        optimizer_e=make_optimizer("adam", 2e-4), optimizer_d=make_optimizer("adam", 2e-4),
        beta_kl=0.5, beta_rec=0.75, beta_neg=512.0, tc_impl=tc_impl, mesh=mesh)
    state = shard_state(replicate_state(solver.init_state(0), mesh), mesh, min_dim=MIN_DIM)
    batch = ds.get_batch(np.arange(shape["batch"]) % len(ds)).transpose(0, 3, 1, 2)
    x = torch.from_numpy(batch[batch_sharding(mesh, shape["batch"])].copy()).to(device)
    calls, original = [], ops.total_correlation

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    comm_counts.reset()
    ops.total_correlation = counted
    try:
        _, metrics = solver.train_step(state, x)
    finally:
        ops.total_correlation = original
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = {**comm_counts.by_kind(), "by_site": comm_counts.by_site()}
    local = sum(p.numel() * p.element_size() for p in state.model.parameters())
    return {**counts, "param_bytes": whole, "param_bytes_rank": local,
            "expected": expected_bytes(state, mesh, len(metrics), len(calls), shape["zdim"],
                                       shape["batch"]),
            "finite": all(bool(torch.isfinite(v).all()) for v in metrics.values())}


def _rank(rank: int, world: int, port: int, tiny: bool, device: str, out_dir: str) -> None:
    """One rank: joins the gloo group, runs every phase, saves its result."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      ITCVAE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    import torch

    from intro_tc_vae_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    torch.set_num_threads(1)
    try:
        if not initialize_distributed():
            raise RuntimeError("initialize_distributed() did not join a group")
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        shape = shapes(tiny, world)
        out = {name: one_step(name, mp, impl, shape, dev) for name, mp, impl in PHASES}
        out["meta"] = dict(n_ranks=world, batch=shape["batch"], image_size=shape["image_size"],
                           channels=list(shape["channels"]), zdim=shape["zdim"],
                           device=str(dev))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown_distributed()


def run_ranks(world: int, tiny: bool, device: str, timeout: float = TIMEOUT) -> list:
    """Every rank's result, in rank order; a rank that fails or outlives
    ``timeout`` fails the call, and the others are killed."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="itcvae-comms-") as out_dir:
        procs = [ctx.Process(target=_rank, args=(r, world, port, tiny, device, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                  if f.endswith(".err")]
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
                               + "\n".join(e[-3000:] for e in errors))
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def mismatches(result: dict) -> list:
    """Where a rank's counts differ from the closed forms."""
    bad = []
    for phase, r in result.items():
        if phase == "meta":
            continue
        if not r["finite"]:
            bad.append(f"{phase}: non-finite metrics")
        for site, want in r["expected"].items():
            got = r["by_site"].get(site, {}).get("bytes", 0)
            if got != want:
                bad.append(f"{phase}: {site} moved {got} bytes, closed form {want}")
    return bad


def print_table(results: dict) -> None:
    """The JAX script's markdown table of one rank's counts."""
    meta = results["meta"]
    print(f"# per-step collective traffic, {meta['n_ranks']} ranks (gloo), batch "
          f"{meta['batch']}, {meta['image_size']}px channels {meta['channels']} (counted "
          f"where issued, rank 0)\n")
    print("| phase | all-reduce | all-gather | reduce-scatter | "
          "perm/a2a | total MB | params MB |")
    print("|---|---|---|---|---|---|---|")
    for name, r in results.items():
        if name == "meta":
            continue

        def cell(k):
            return f"{r[k]['count']}x / {r[k]['bytes'] / 1e6:.2f} MB"

        print(f"| {name} | {cell('all-reduce')} | {cell('all-gather')} | "
              f"{cell('reduce-scatter')} | 0x | {r['total_bytes'] / 1e6:.2f} | "
              f"{r['param_bytes'] / 1e6:.2f} |")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized model instead of flagship shapes")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "scaling_comms_torch.json"))
    a = ap.parse_args(argv)
    if a.ranks < 2 or a.ranks % 2:
        raise SystemExit("--ranks must be even and at least 2 (the TP2 phase)")

    ranks = run_ranks(a.ranks, a.tiny, a.device)
    results = ranks[0]
    bad = [f"rank {r}: {m}" for r, res in enumerate(ranks) for m in mismatches(res)]
    with open(a.out, "w") as f:
        json.dump({**results, "ranks": ranks[1:]}, f, indent=2)

    print_table(results)
    print(f"\nwrote {a.out}")
    out = {"metric": "scaling_comms", **results, "closed_form_ok": not bad}
    print(json.dumps(out))
    if bad:
        print("FAILED: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
