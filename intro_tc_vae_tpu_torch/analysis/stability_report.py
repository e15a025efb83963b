"""Long-horizon stability report for a training run, from its TensorBoard log.

Counterpart of ``analysis/stability_report.py`` (the JAX package's), with
its arguments and outputs: reads a finished run's events through the
port's ``utils/tb_reader.py``, checks that every logged curve of the six
(lossE, lossD, the unscaled reconstruction and KL terms, the scaled
expELBO of the fakes, diff_kl) is finite over the whole run, and writes
``<out>.json`` (each curve's steps, finiteness, first, final, min and
max) and the loss-curve figure ``<out>.png``. Exit code 1 when a curve
is not finite.

    python -m intro_tc_vae_tpu_torch.analysis.stability_report \\
        --run-dir runs --run-pattern intro_tc --out /tmp/stability_report

The figure is drawn with matplotlib, imported where it is drawn; where
matplotlib does not import, the report says so by the figure's name and
writes the JSON alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def curves_of(reader) -> dict:
    """The six curves, name -> DataFrame (step, value)."""
    return {
        "lossE": reader.loss_e,
        "lossD": reader.loss_d,
        "rec (unscaled)": reader.r_loss,
        "kl (unscaled)": reader.kl_loss,
        "expelbo_f": reader.expelbo_f_loss_scaled,
        "diff_kl": reader.diff_kl,
    }


def summarize(curves: dict) -> tuple:
    """({name: steps, finite, first, final, min, max}, [non-finite names])."""
    summary, bad = {}, []
    for name, df in curves.items():
        v = np.asarray(df["value"], dtype=np.float64)
        finite = bool(np.isfinite(v).all())
        if not finite:
            bad.append(name)
        summary[name] = {
            "steps": int(len(v)),
            "finite": finite,
            "first": float(v[0]),
            "final": float(v[-1]),
            "min": float(np.nanmin(v)),
            "max": float(np.nanmax(v)),
        }
    return summary, bad


def draw(curves: dict, run: str, path: str) -> bool:
    """The 2 x 3 loss-curve figure at ``path`` (a running mean over long
    curves, a log scale where a positive curve spans three decades);
    False where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(15, 7))
    for ax, (name, df) in zip(axes.flat, curves.items()):
        steps = np.asarray(df["step"])
        v = np.asarray(df["value"], dtype=np.float64)
        ax.plot(steps, v, lw=0.6, alpha=0.5)
        if len(v) > 20:
            k = max(5, len(v) // 100)
            sm = np.convolve(v, np.ones(k) / k, mode="valid")
            ax.plot(steps[k - 1:], sm, lw=1.5)
        ax.set_title(name)
        ax.set_xlabel("step")
        if np.nanmin(v) > 0 and np.nanmax(v) / max(np.nanmin(v), 1e-12) > 1e3:
            ax.set_yscale("log")
    fig.suptitle(f"run: {run}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True,
                    help="directory containing the runs' folder(s)")
    ap.add_argument("--run-pattern", default="intro_tc",
                    help="substring/regex matching the run folder name")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "stability_report"))
    a = ap.parse_args(argv)

    from intro_tc_vae_tpu_torch.utils.tb_reader import TensorboardReader

    run = TensorboardReader.match_name(a.run_dir, a.run_pattern, regex=True)
    reader = TensorboardReader(a.run_dir, run)
    if not reader.exists:
        raise SystemExit(f"no events under {a.run_dir}/{run}")
    curves = curves_of(reader)
    summary, bad = summarize(curves)

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    drawn = draw(curves, run, a.out + ".png")
    with open(a.out + ".json", "w") as f:
        json.dump({"run": run, "curves": summary}, f, indent=2)

    print(json.dumps({k: {"final": s["final"], "finite": s["finite"], "steps": s["steps"]}
                      for k, s in summary.items()}, indent=2))
    if not drawn:
        print(f"figure {a.out}.png not drawn: matplotlib does not import")
    if bad:
        print(f"NON-FINITE values in: {bad}")
        sys.exit(1)
    print(f"all curves finite; wrote {a.out}.json" + (f" / {a.out}.png" if drawn else ""))
    return {"run": run, "curves": summary, "figure": a.out + ".png" if drawn else None}


if __name__ == "__main__":
    main()
