"""Four disentanglement metric families, each as a compute_* / write_* pair.

A copy of ``intro_tc_vae_tpu/evaluation/metrics.py`` (parity surface of
reference evaluation/metrics.py: beta-VAE score metrics.py:11-79, DCI
:82-161, MIG :164-219, Modularity/Explicitness :222-304), with the same
TensorBoard tags and DCI parameters. All take a ``latent_generator`` and
an ``encode_fn(images) -> (mu, logvar)`` over the port's eval-mode
encoder. scikit-learn is imported where a classifier is fitted: without
it, MIG and modularity still compute, and ``write_mod_expl_score`` writes
modularity before explicitness raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from intro_tc_vae_tpu_torch.evaluation import utils
from intro_tc_vae_tpu_torch.evaluation.generator import LatentGenerator
from intro_tc_vae_tpu_torch.evaluation.utils import EncodeFn


# ---------------------------------------------------------------------------
# beta-VAE factor-change score
# ---------------------------------------------------------------------------

def write_bvae_score(writer, cur_iter: int, **score_kwargs):
    bvae_score, bvae_score_scaled = compute_bvae_score(**score_kwargs)
    writer.add_scalars(
        "bvae_score",
        dict(score=bvae_score, scaled=bvae_score_scaled),
        global_step=cur_iter,
    )


def compute_bvae_score(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int = 10000,
    batch_size: int = 64,
) -> Tuple[float, float]:
    """beta-VAE metric (Higgins et al., section 3): accuracy of a linear
    classifier predicting which factor was held fixed from z_diff.

    Returns (raw score, score with standard-scaled inputs).
    """
    z_diff_train, y_train = utils.generate_factor_change(
        latent_generator, encode_fn, num_samples, batch_size=batch_size
    )
    z_diff_test, y_test = utils.generate_factor_change(
        latent_generator, encode_fn, num_samples, batch_size=batch_size
    )
    score = utils.compute_factor_change_accuracy(
        z_diff_train, y_train, z_diff_test, y_test, params=dict(scale=False)
    )
    score_scaled = utils.compute_factor_change_accuracy(
        z_diff_train, y_train, z_diff_test, y_test, params=dict(scale=True)
    )
    return score, score_scaled


# ---------------------------------------------------------------------------
# DCI
# ---------------------------------------------------------------------------

def write_dci_score(writer, cur_iter: int, **score_kwargs):
    info, comp, dis = compute_dci_score(
        **score_kwargs,
        params=dict(
            informativeness_method="xgb",  # falls back to sklearn if absent
            informativeness_params=dict(tree_method="hist", eval_metric="mlogloss"),
        ),
    )
    writer.add_scalars(
        "dci",
        dict(
            dci_informativeness_score=info,
            dci_completeness_score=comp,
            dci_disentanglement_score=dis,
        ),
        global_step=cur_iter,
    )


def compute_dci_score(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int = 10000,
    batch_size: int = 64,
    params=None,
) -> Tuple[float, float, float]:
    """Disentanglement / Completeness / Informativeness (Eastwood & Williams):
    per-factor classifier -> feature-importance matrix P -> entropy scores.

    Returns (informativeness, completeness, disentanglement).
    """
    params = params or {}
    x_train, y_train = utils.generate_factor_representations(
        latent_generator, encode_fn, num_samples=num_samples, batch_size=batch_size
    )
    x_test, y_test = utils.generate_factor_representations(
        latent_generator, encode_fn, num_samples=num_samples, batch_size=batch_size
    )
    _, test_acc, P = utils.fit_info_clf(x_train, y_train, x_test, y_test, params=params)
    return test_acc, utils.compute_completeness(P), utils.compute_disentanglement(P)


# ---------------------------------------------------------------------------
# MIG
# ---------------------------------------------------------------------------

def write_mig_score(writer, cur_iter: int, **score_kwargs):
    writer.add_scalar("mig_score", compute_mig_score(**score_kwargs),
                      global_step=cur_iter)


def compute_mig_score(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int = 10000,
    batch_size: int = 64,
    params=None,
) -> float:
    """Mutual Information Gap (Chen et al., eq. 6): normalized gap between
    the two latents most informative about each factor."""
    params = params or {}
    bins = params.get("bins", 10)
    mu, v = utils.generate_factor_representations(
        latent_generator, encode_fn, num_samples=num_samples, batch_size=batch_size
    )
    mu_binned = utils.discretize(mu, bins=bins)
    entropy = utils.calculate_entropy(v)
    mi = utils.calculate_mutual_info(mu_binned, v)
    mi_sorted = np.sort(mi, axis=0)[::-1]
    return float(np.mean((mi_sorted[0] - mi_sorted[1]) / entropy))


# ---------------------------------------------------------------------------
# Modularity / Explicitness
# ---------------------------------------------------------------------------

def write_mod_expl_score(writer, cur_iter: int, **score_kwargs):
    """Both scores under "mod_expl"; where explicitness raises (no
    sklearn), modularity is written before the error propagates."""
    scores: dict = {}
    try:
        _, explicitness = compute_mod_expl_score(
            **score_kwargs,
            params=dict(explicitness_lr_params={"solver": "saga", "max_iter": 300}),
            scores=scores,
        )
        scores["explicitness_score"] = explicitness
    finally:
        if scores:
            writer.add_scalars("mod_expl", scores, global_step=cur_iter)


def compute_mod_expl_score(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int = 10000,
    batch_size: int = 64,
    params=None,
    scores: Optional[dict] = None,
) -> Tuple[float, float]:
    """Modularity (MI template deviation) + Explicitness (one-vs-rest AUC)
    of Ridgeway & Mozer, eq. 2. ``scores``, when given, receives
    ``modularity_score`` as soon as it is computed, before explicitness
    needs sklearn."""
    params = params or {}
    bins = params.get("bins", 20)
    x_train, y_train = utils.generate_factor_representations(
        latent_generator, encode_fn, num_samples=num_samples, batch_size=batch_size
    )
    x_test, y_test = utils.generate_factor_representations(
        latent_generator, encode_fn, num_samples=num_samples, batch_size=batch_size
    )
    x_train_binned = utils.discretize(x_train, bins=bins)
    mi = utils.calculate_mutual_info(x_train_binned, y_train)
    modularity = utils.compute_modularity(mi)
    if scores is not None:
        scores["modularity_score"] = modularity

    from sklearn.preprocessing import StandardScaler

    scl = StandardScaler()
    x_train = scl.fit_transform(x_train)
    x_test = scl.transform(x_test)
    _, val_explicitness = utils.compute_explicitness(
        x_train, y_train, x_test, y_test, params=params
    )
    return modularity, val_explicitness
