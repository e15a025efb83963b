"""Model visualization: latent projections, traversals and interpolations
of a trained model.

Counterpart of ``analysis/model_vis.py`` (the JAX package's; the
reference's ModelVis.ipynb), with its arguments and figures. It builds the
port's ``SoftIntroVAE`` from the arguments (``build_model``), restores a
checkpoint's parameters and BatchNorm statistics (``utils.load_model``),
encodes up to 2,000 images through the solver's eval-mode encoder
(``encode_dataset``) and writes:

* ``latents_{pca,tsne,lda,umap}.png``: 2-D projections of the encoder
  means coloured by label (sklearn's PCA, t-SNE and LDA; umap-learn where
  it is installed); a projection that cannot be made is skipped with its
  reason, as in JAX;
* ``traversals.png``: each of the first 16 latents of the first image's
  code swept over -5..5 in 11 steps, decoded in eval mode;
* ``interpolations.png``: 4 pairs of random images, their codes mixed in
  8 steps, decoded in eval mode.

    python -m intro_tc_vae_tpu_torch.analysis.model_vis --checkpoint saves/<prefix>model_epoch_E_iter_I \\
        --dataset synthetic --arch res --z-dim 32 --out /tmp/modelvis

The encodes and decodes run on the card unless ``--device cpu``, in true
fp32 (TF32 off, ``train.true_fp32``). matplotlib and sklearn are imported
where they are used; where either does not import, the figures it would
draw are named as not drawn. The last line is one JSON object: what was
drawn, what was skipped and why.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def build_model(arch: str, zdim: int, dataset_name: str, data_root=None, device="cuda"):
    """(solver, state, dataset): the ``vae`` solver over a fresh model of
    the dataset's shapes on ``device``."""
    import torch

    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    dataset, image_size, channels, cdim = load_dataset(dataset_name, data_root)
    kwargs = dict(arch=arch, cdim=cdim, zdim=zdim, channels=tuple(channels),
                  image_size=image_size)
    device = torch.device(device)
    solver = make_solver(
        "vae",
        dataset=dataset,
        encoder=Encoder(**kwargs).to(device),
        decoder=Decoder(**kwargs).to(device),
        batch_size=64,
        optimizer_e=make_optimizer("adam", 2e-4),
        optimizer_d=make_optimizer("adam", 2e-4),
    )
    return solver, solver.init_state(0), dataset


def encode_dataset(solver, state, dataset, max_samples=2000, batch=64):
    """(encoder means [N, z], labels [N, ...]) of the first ``max_samples``
    images, in batches, through the eval-mode encoder."""
    encode_fn = solver.make_eval_encoder(state)
    n = min(len(dataset), max_samples)
    mus, labels = [], []
    for start in range(0, n, batch):
        idx = np.arange(start, min(start + batch, n))
        mu, _ = encode_fn(dataset.get_batch(idx))
        mus.append(mu)
        labels.extend(dataset[i][1] for i in idx)
    return np.vstack(mus), np.asarray(labels)


def decode_codes(state, zs) -> np.ndarray:
    """Eval-mode decodes of the codes ``zs`` [N, z] on the model's device,
    NHWC images in [0, 1]."""
    import torch

    from intro_tc_vae_tpu_torch.solvers.base import decode

    decoder = state.model.decoder
    device = next(decoder.parameters()).device
    z = torch.as_tensor(np.asarray(zs, np.float32), device=device)
    return decode(decoder, z, train=False).permute(0, 2, 3, 1).cpu().numpy()


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_projections(z, labels, out_dir) -> dict:
    """{projection: "drawn" or "skipped: <reason>"}, each drawn to
    ``latents_<name>.png``."""
    color = labels if labels.ndim == 1 else labels[:, 0]
    plt = _pyplot()
    try:
        from sklearn.decomposition import PCA
        from sklearn.discriminant_analysis import LinearDiscriminantAnalysis
        from sklearn.manifold import TSNE
    except ImportError as e:
        why = f"skipped: {e!r}"
        return {"pca": why, "tsne": why, "lda": why, "umap": why}
    status, projs = {}, {"pca": PCA(n_components=2).fit_transform(z)}
    try:
        projs["tsne"] = TSNE(n_components=2, init="pca").fit_transform(z)
    except Exception as e:  # t-SNE can be slow or fragile; not load-bearing
        status["tsne"] = f"skipped: {e!r}"
    try:
        projs["lda"] = LinearDiscriminantAnalysis(n_components=2).fit_transform(
            z, color.astype(int))
    except Exception as e:
        status["lda"] = f"skipped: {e!r}"
    try:  # the reference's "Apply UMAP" cell; umap-learn is optional
        from umap import UMAP

        projs["umap"] = UMAP(n_components=2).fit_transform(z)
    except Exception as e:
        status["umap"] = f"skipped (install umap-learn to enable): {e!r}"
    for name, p in projs.items():
        if plt is None:
            status[name] = "skipped: matplotlib does not import"
            continue
        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(p[:, 0], p[:, 1], c=color, s=4, cmap="tab20")
        fig.colorbar(sc)
        ax.set_title(f"latents ({name})")
        fig.savefig(os.path.join(out_dir, f"latents_{name}.png"), dpi=120)
        plt.close(fig)
        status[name] = "drawn"
    for name, why in status.items():
        if why != "drawn":
            print(f"{name} {why}")
    return status


def _grid(rows: list, path: str) -> bool:
    """A grid of NHWC images, one row per list entry, at ``path``; False
    where matplotlib does not import."""
    plt = _pyplot()
    if plt is None:
        return False
    n_rows, n_cols = len(rows), len(rows[0])
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(n_cols, n_rows))
    axes = np.asarray(axes).reshape(n_rows, n_cols)
    for r, imgs in enumerate(rows):
        for c in range(n_cols):
            ax = axes[r][c]
            ax.imshow(np.squeeze(imgs[c]), cmap="gray" if imgs.shape[-1] == 1 else None)
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def traversals(state, z_base, span=5.0, steps=11, max_dims=16) -> list:
    """Per latent d of the first ``max_dims``: the decodes [steps, H, W, C]
    of ``z_base`` with latent d swept over -span..span."""
    vals = np.linspace(-span, span, steps)
    out = []
    for d in range(min(z_base.shape[-1], max_dims)):
        zs = np.repeat(z_base[None, :], steps, axis=0)
        zs[:, d] = vals
        out.append(decode_codes(state, zs))
    return out


def plot_traversals(solver, state, z_base, out_dir, span=5.0, steps=11, max_dims=16):
    """``traversals`` drawn to ``traversals.png``; (images, drawn)."""
    rows = traversals(state, z_base, span, steps, max_dims)
    return rows, _grid(rows, os.path.join(out_dir, "traversals.png"))


def interpolations(solver, state, dataset, pairs=4, steps=8) -> list:
    """Per pair of random images (RandomState(0)): the decodes [steps, H,
    W, C] of their codes mixed linearly in ``steps`` steps."""
    encode_fn = solver.make_eval_encoder(state)
    rng = np.random.RandomState(0)
    out = []
    for _ in range(pairs):
        i, j = rng.randint(len(dataset), size=2)
        mu, _ = encode_fn(dataset.get_batch(np.array([i, j])))
        alphas = np.linspace(0, 1, steps)[:, None]
        out.append(decode_codes(state, (1 - alphas) * mu[0] + alphas * mu[1]))
    return out


def plot_interpolations(solver, state, dataset, out_dir, pairs=4, steps=8):
    """``interpolations`` drawn to ``interpolations.png``; (images, drawn)."""
    rows = interpolations(solver, state, dataset, pairs, steps)
    return rows, _grid(rows, os.path.join(out_dir, "interpolations.png"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=False, default=None)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--arch", default="res")
    ap.add_argument("--z-dim", type=int, default=32)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "modelvis"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    from intro_tc_vae_tpu_torch.train import true_fp32

    os.makedirs(a.out, exist_ok=True)
    solver, state, dataset = build_model(a.arch, a.z_dim, a.dataset, a.data_root, a.device)
    if a.checkpoint:
        from intro_tc_vae_tpu_torch.utils import load_model

        state = load_model(state, a.checkpoint)
    with true_fp32("fp32"):
        z, labels = encode_dataset(solver, state, dataset)
        projections = plot_projections(z, labels, a.out)
        _, trav = plot_traversals(solver, state, z[0], a.out)
        _, interp = plot_interpolations(solver, state, dataset, a.out)
    drawn = {"traversals.png": trav, "interpolations.png": interp,
             **{f"latents_{k}.png": v == "drawn" for k, v in projections.items()}}
    not_drawn = sorted(k for k, v in drawn.items() if not v)
    if not_drawn:
        print("not drawn: " + ", ".join(not_drawn))
    print("wrote visualizations to", a.out)
    out = {"metric": "model_vis", "device": a.device, "encoded": int(len(z)),
           "projections": projections, "drawn": sorted(k for k, v in drawn.items() if v),
           "not_drawn": not_drawn}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
