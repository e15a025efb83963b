"""The 128 px recipe's metric trends over a training horizon.

Counterpart of ``analysis/eval_config5_trend.py`` (the JAX package's),
with its arguments, points, JSON keys and figure: trains
``configs/intro_tc_128_dp8.json``'s recipe (``eval_config5.build``; the
step graphed on the card) for ``--steps`` steps and evaluates at
``--eval-points`` + 1 evenly spaced steps, step 0 included:

* the four disentanglement families (``eval_config5.scores``);
* FID between real images and prior samples in a fixed feature space:
  the prior samples are drawn at every point but embedded with the final
  encoder (``evaluation/fid.py::encoder_features``), so the points are
  comparable (``fid_final_encoder``); Inception-pool3 FID too where a
  local weights file exists.

``--scan`` K maps to ``scan_steps``: K steps a ``train_step`` call (K
graph replays on the card). The JAX script's three faults are fixed here:
K is the largest width up to ``--scan`` that divides every spacing of the
eval points (``scan_width``: a call never steps over a point); the finite
check covers every inner step of every call (``eval_config5.
drain_finite``: every step's metrics, not the last step's loss, drained
as ``eval_config5`` drains them, the two newest calls left in the ring
until the next eval point); and
``<out>.partial.json``, written after each point against a late failure,
is removed once the final ``<out>.json`` is written.

    python -m intro_tc_vae_tpu_torch.analysis.eval_config5_trend --steps 10000 --eval-points 6

Writes ``<out>.json`` and ``<out>.png`` (default
``docs/eval_config5_trend_torch``; the JAX script's
``docs/eval_config5_trend.*`` are its own); the figure is drawn with
matplotlib where it imports, else named as not drawn. ``--num-samples``
keeps the JAX default of 640, so the two trends stay comparable. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def eval_steps(steps: int, points: int) -> list:
    """The JAX script's eval steps: round(steps i / points), i = 0..points."""
    return sorted({round(steps * i / points) for i in range(points + 1)})


def scan_width(scan: int, eval_at: list) -> int:
    """The largest K <= ``scan`` that divides every gap between
    consecutive eval steps (1 when none but 1 does)."""
    g = 0
    for a, b in zip(eval_at, eval_at[1:]):
        g = math.gcd(g, b - a)
    if g == 0:
        return 1
    return max(k for k in range(1, min(scan, g) + 1) if g % k == 0)


def draw(points: list, path: str, title: str) -> bool:
    """The 2 x 3 trend figure at ``path``; False where matplotlib does not
    import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps_x = [p["step"] for p in points]
    fig, axes = plt.subplots(2, 3, figsize=(14, 7))
    panels = [
        ("fid_final_encoder", "FID (final-encoder features)", False),
        ("loss_rec", "reconstruction loss", False),
        ("bvae_score", "beta-VAE score", True),
        ("dci_disentanglement", "DCI disentanglement", True),
        ("mig_score", "MIG", True),
        ("modularity", "modularity", True),
    ]
    extra = {"dci_disentanglement": [("dci_completeness", "completeness")],
             "modularity": [("explicitness", "explicitness")]}
    for ax, (key, panel, up) in zip(axes.ravel(), panels):
        ys = [p.get(key) for p in points]
        if all(y is None for y in ys):
            ax.set_visible(False)
            continue
        ax.plot(steps_x, ys, "o-", label=key)
        for k2, lbl in extra.get(key, []):
            ax.plot(steps_x, [p.get(k2) for p in points], "s--", label=lbl)
            ax.legend(fontsize=8)
        ax.set_title(panel + (" (higher=better)" if up else " (lower=better)"))
        ax.set_xlabel("train step")
        ax.grid(alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--eval-points", type=int, default=6,
                    help="number of eval checkpoints after step 0")
    ap.add_argument("--dataset", default="synthetic128")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scan", type=int, default=10,
                    help="train steps a train_step call (scan_steps), at most")
    ap.add_argument("--num-samples", type=int, default=640)
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "eval_config5_trend_torch"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    from intro_tc_vae_tpu_torch.analysis.eval_config5 import (
        build,
        drain_finite,
        sample_prior,
        scores,
        train_call,
    )
    from intro_tc_vae_tpu_torch.evaluation.fid import (
        encoder_features,
        frechet_distance,
        standard_fid,
    )
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH
    from intro_tc_vae_tpu_torch.train import true_fp32

    device = torch.device(a.device)
    eval_at = eval_steps(a.steps, a.eval_points)
    k = scan_width(a.scan, eval_at)
    solver, state, dataset, cfg = build(a.dataset, a.data_root, a.batch, device,
                                        scan_steps=k)
    print(f"eval checkpoints: {eval_at}; {k} steps a call")
    rng = np.random.RandomState(0)
    n = len(dataset)
    num_scored = min(a.num_samples, n // 2)
    real = dataset.get_batch(rng.randint(n, size=a.num_samples))
    points, fakes_per_point = [], []
    step, next_print, last = 0, 500, None
    t0 = time.time()
    for target in eval_at:
        while step < target:
            train_call(solver, state, dataset, rng, a.batch, device)
            step += k
            if len(solver.metric_ring) >= RING_DEPTH + 2:  # the host waits on no recent call
                last = drain_finite(solver, keep_tail=2)[-1][0]
            if step >= next_print and last is not None:
                next_print += 500
                print(f"step {step}/{a.steps} lossE={last['loss_enc']:.4f} "
                      f"rec={last['loss_rec']:.1f} [{time.time() - t0:.0f}s]")
        drained = drain_finite(solver)  # every inner step before the point
        if drained:
            last = drained[-1][0]
        point = {"step": step}
        if last is not None:
            point["loss_rec"] = round(last["loss_rec"], 2)
            point["loss_enc"] = round(last["loss_enc"], 4)
        te = time.time()
        with true_fp32("fp32"):
            fakes_per_point.append(sample_prior(state, a.num_samples, a.batch, cfg["z_dim"],
                                                seed=1000 + step))
            point.update(scores(solver, state, num_scored, a.batch))
        point["eval_seconds"] = round(time.time() - te, 1)
        points.append(point)
        print(f"eval @ {step}: " + json.dumps({kk: v for kk, v in point.items()
                                                if kk != "step"}))
        # against a late failure of a long run: the points so far
        with open(a.out + ".partial.json", "w") as f:
            json.dump({"points": points, "through_step": step}, f, indent=2)

    # FID of every point in the final encoder's fixed feature space
    with true_fp32("fp32"):
        feats_real = encoder_features(solver, state, real, batch_size=a.batch)
        mu_r, cov_r = feats_real.mean(0), np.cov(feats_real, rowvar=False)
        for point, fake in zip(points, fakes_per_point):
            fid_std = standard_fid(real, fake, batch_size=a.batch, device=device)
            if fid_std is not None:
                point["fid_inception_pool3"] = round(fid_std, 3)
            f = encoder_features(solver, state, fake, batch_size=a.batch)
            point["fid_final_encoder"] = round(
                frechet_distance(mu_r, cov_r, f.mean(0), np.cov(f, rowvar=False)), 3)

    results = {
        "config": "intro_tc_128_dp8 (BASELINE config 5)",
        "dataset": a.dataset, "steps": a.steps,
        "num_samples": a.num_samples,
        "fid_note": "fid_final_encoder embeds every checkpoint's prior "
                    "samples with the FINAL encoder (fixed feature space)",
        "points": points,
        "total_seconds": round(time.time() - t0, 1),
    }
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out + ".json", "w") as f:
        json.dump(results, f, indent=2)
    os.remove(a.out + ".partial.json")
    print(json.dumps(results, indent=2))
    drawn = draw(points, a.out + ".png",
                 f"config 5 (intro_tc 128px) metric trends — {a.dataset}, "
                 f"{a.steps} steps, b{a.batch}")
    print(f"wrote {a.out}.json" + (f" / {a.out}.png" if drawn else
                                   f"; figure {a.out}.png not drawn: matplotlib does "
                                   "not import"))
    print(json.dumps({**results, "scan_steps": k, "figure": a.out + ".png" if drawn else None}))
    return results


if __name__ == "__main__":
    main()
