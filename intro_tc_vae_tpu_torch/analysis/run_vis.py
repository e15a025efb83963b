"""Run comparison: curves across TensorBoard runs and each run's last
reconstruction.

Counterpart of ``analysis/run_vis.py`` (the JAX package's; the reference's
RunVis.ipynb), with its arguments, ``CURVES`` and figures: for every run
folder under ``--run-dir``, read through the port's ``utils/tb_reader.py``,
one figure a curve (``<attr>.png``, a line per run that logged it) and the
run's last logged reconstruction (``recon_<run>.png``).

    python -m intro_tc_vae_tpu_torch.analysis.run_vis --run-dir runs --out /tmp/runvis

matplotlib is imported where the figures are drawn; where it does not
import, the curve figures are named as not drawn (the reconstructions,
written with PIL, still are). The last line is one JSON object: per run,
each curve's steps and final value, the curves drawn and the files
written.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

CURVES = [
    ("r_loss_scaled", "reconstruction loss (scaled)"),
    ("kl_loss_scaled", "KL loss (scaled)"),
    ("loss_e", "lossE"),
    ("loss_d", "lossD"),
    ("diff_kl", "diff_kl"),
    ("mig_score", "MIG"),
]


def read_curves(readers: dict) -> dict:
    """{run: {attr: DataFrame}} of the CURVES each run logged."""
    out = {}
    for name, reader in readers.items():
        out[name] = {}
        for attr, _ in CURVES:
            try:
                out[name][attr] = getattr(reader, attr)
            except Exception:  # a run that did not log this curve
                continue
    return out


def summary(curves: dict) -> dict:
    """{run: {attr: {steps, final}}}."""
    return {run: {attr: {"steps": int(len(df)), "final": float(df["value"].iloc[-1])}
                  for attr, df in by_attr.items()}
            for run, by_attr in curves.items()}


def draw_curves(curves: dict, out_dir: str) -> list:
    """One figure a curve that some run logged; the files written (none
    where matplotlib does not import)."""
    try:
        import matplotlib
    except ImportError:
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []
    for attr, title in CURVES:
        runs = [(name, by_attr[attr]) for name, by_attr in curves.items() if attr in by_attr]
        if not runs:
            continue
        fig, ax = plt.subplots(figsize=(8, 4))
        for name, df in runs:
            ax.plot(df["step"], df["value"], label=name[:60], lw=1)
        ax.set_title(title)
        ax.set_xlabel("step")
        ax.legend(fontsize=6)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{attr}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", default="runs")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "runvis"))
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)

    from intro_tc_vae_tpu_torch.utils.tb_reader import TensorboardReader

    runs = sorted(p.name for p in Path(a.run_dir).iterdir() if p.is_dir())
    if not runs:
        print(f"no runs found under {a.run_dir}")
        return {"runs": {}}
    readers = {r: TensorboardReader(a.run_dir, r) for r in runs}
    curves = read_curves(readers)
    figures = draw_curves(curves, a.out)
    logged = [attr for attr, _ in CURVES if any(attr in c for c in curves.values())]
    if not figures:
        print("curve figures not drawn (matplotlib does not import): "
              + ", ".join(f"{attr}.png" for attr in logged))

    recons = []
    for name, reader in readers.items():
        try:
            img = reader.last_reconstruction
        except Exception:  # a run that logged no image
            continue
        path = os.path.join(a.out, f"recon_{name[:40]}.png")
        img.save(path)
        recons.append(path)

    print("wrote run comparisons to", a.out)
    out = {"metric": "run_vis", "runs": summary(curves), "figures": figures,
           "not_drawn": [] if figures else [f"{attr}.png" for attr in logged],
           "reconstructions": recons}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
