"""Fréchet distance metrics (FID-style generative quality evaluation).

Counterpart of ``intro_tc_vae_tpu/evaluation/fid.py`` (the reference repo
itself has no FID code; BASELINE.json's config 5 asks for "FID +
disentanglement metric eval"):

* ``frechet_distance(mu1, cov1, mu2, cov2)`` — the closed-form 2-Wasserstein
  distance between Gaussians fit to feature sets (numpy, float64),
* ``compute_fid(feature_fn, real, fake)`` — batch features, fit moments,
  return the distance,
* ``encoder_fid(...)`` — the model's own encoder means as the feature
  space ("encoder-FID"), from the solver's eval-mode encoder on its
  device,
* ``standard_fid(...)`` — InceptionV3-pool3 features
  (``models/inception.py``) on the device, or None when no local weights
  file exists; nothing is downloaded.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def gaussian_moments(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean [D], covariance [D, D]) of a feature matrix [N, D]."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    cov = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d² = |mu1-mu2|² + tr(cov1 + cov2 - 2·sqrt(cov1·cov2)).

    Uses the similarity-transform trick: the needed trace equals
    tr(sqrt( sqrt(cov1)·cov2·sqrt(cov1) )), which keeps everything
    symmetric PSD (no scipy.linalg.sqrtm of a non-symmetric product).
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(len(mu1))
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(len(mu2))
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1 @ cov2 @ s1)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner))


def compute_fid(
    feature_fn: Callable[[np.ndarray], np.ndarray],
    real: np.ndarray,
    fake: np.ndarray,
    batch_size: int = 64,
) -> float:
    """Fréchet distance between feature distributions of two image sets.

    feature_fn: [B, H, W, C] float images -> [B, D] features.
    """
    def features_of(images):
        feats = []
        for start in range(0, len(images), batch_size):
            feats.append(np.asarray(feature_fn(images[start:start + batch_size])))
        return np.concatenate(feats, axis=0)

    mu_r, cov_r = gaussian_moments(features_of(real))
    mu_f, cov_f = gaussian_moments(features_of(fake))
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


def encoder_features(solver, state, images: np.ndarray,
                     batch_size: int = 64) -> np.ndarray:
    """Encoder-mean embeddings [N, zdim] of an image set (eval-mode BN)."""
    encode_fn = solver.make_eval_encoder(state)
    feats = []
    for start in range(0, len(images), batch_size):
        mu, _ = encode_fn(images[start:start + batch_size])
        feats.append(np.asarray(mu))
    return np.concatenate(feats, axis=0)


def encoder_fid(solver, state, real: np.ndarray, fake: np.ndarray,
                batch_size: int = 64) -> float:
    """FID in the model's own encoder-mean feature space."""
    encode_fn = solver.make_eval_encoder(state)

    def feature_fn(images):
        mu, _ = encode_fn(images)
        return mu

    return compute_fid(feature_fn, real, fake, batch_size=batch_size)


def standard_fid(real: np.ndarray, fake: np.ndarray, batch_size: int = 64,
                 weights_path: Optional[str] = None,
                 device=None) -> Optional[float]:
    """Canonical FID: InceptionV3-pool3 features (models/inception.py) on
    ``device`` (cuda:0 unless the caller passes another).

    Returns None when no pretrained Inception weights are available
    locally ($ITCVAE_INCEPTION_WEIGHTS / ~/.cache/itcvae/inception_v3.pth);
    callers should fall back to :func:`encoder_fid` and label the metric
    accordingly.
    """
    from intro_tc_vae_tpu_torch.models.inception import inception_feature_fn

    feature_fn = inception_feature_fn(weights_path, device=device)
    if feature_fn is None:
        return None
    return compute_fid(feature_fn, real, fake, batch_size=batch_size)
