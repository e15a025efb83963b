"""Metric helpers: representation generation, classifiers, MI estimation.

A copy of ``intro_tc_vae_tpu/evaluation/utils.py`` (parity surface of
reference evaluation/utils.py). The encoder runs as an ``encode_fn`` over
the port's eval-mode encoder on the device, returning numpy latents.
scikit-learn is imported inside the functions that fit a classifier
(``compute_factor_change_accuracy``, ``fit_info_clf``,
``compute_explicitness``, ``_resolve_informativeness_estimator``), never
at import: MIG (``discretize``, ``calculate_mutual_info``,
``calculate_entropy``) and ``compute_modularity`` are numpy only and run
where sklearn is absent. DCI's informativeness classifier resolves in
order xgb (if importable, hist method) -> requested sklearn estimator
(the reference hardcodes xgboost gpu_hist, quirk Q13).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from intro_tc_vae_tpu_torch import ops
from intro_tc_vae_tpu_torch.evaluation.generator import LatentGenerator

EncodeFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


def generate_factor_representations(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int,
    batch_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample observations and return (mu latents, ground-truth factors).

    Reference: evaluation/utils.py:14-56.
    """
    representations, factors = [], []
    for factors_batch, observations_batch in latent_generator.generate(
        num_samples, batch_size, drop_last=False
    ):
        mu, _ = encode_fn(observations_batch)
        representations.append(np.asarray(mu))
        factors.append(factors_batch)
    return np.vstack(representations), np.vstack(factors)


# ---------------------------------------------------------------------------
# beta-VAE score
# ---------------------------------------------------------------------------

def generate_factor_change_batch(
    latent_generator: LatentGenerator, encode_fn: EncodeFn, batch_size: int
) -> Tuple[np.ndarray, int]:
    """One (z_diff, y) training point for the beta-VAE metric
    (reference utils.py:60-111).

    Quirk Q14 (PARITY.md): re-seeding RandomState(generator.seed) on every
    call matches the reference exactly — with a non-None seed every batch
    would pick the SAME factor_index and the score degenerates. Only use
    seed=None (the shipped default) here.
    """
    random_state = np.random.RandomState(latent_generator.seed)
    factor_index = random_state.randint(latent_generator.num_latents)

    v_li = latent_generator.sample_factors_of_variation(batch_size)
    v_lj = latent_generator.sample_factors_of_variation(batch_size)
    v_li[:, factor_index] = v_lj[:, factor_index]

    x_li = latent_generator.sample_observations_from_factors(v_li)
    x_lj = latent_generator.sample_observations_from_factors(v_lj)

    z_mean_li, _ = encode_fn(x_li)
    z_mean_lj, _ = encode_fn(x_lj)

    z_mean_li = np.asarray(z_mean_li).reshape(batch_size, -1)
    z_mean_lj = np.asarray(z_mean_lj).reshape(batch_size, -1)
    z_diff = np.mean(np.abs(z_mean_li - z_mean_lj), axis=0)
    return z_diff, factor_index


def generate_factor_change(
    latent_generator: LatentGenerator,
    encode_fn: EncodeFn,
    num_samples: int,
    batch_size: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """num_samples/batch_size (z_diff, y) pairs (reference utils.py:114-153)."""
    z_diffs, ys = [], []
    for _ in range(int(np.ceil(num_samples / batch_size))):
        z_diff, y = generate_factor_change_batch(latent_generator, encode_fn, batch_size)
        z_diffs.append(z_diff)
        ys.append(y)
    return np.array(z_diffs, dtype=np.float32), np.array(ys, dtype=np.int8)


def compute_factor_change_accuracy(x_train, y_train, x_test, y_test, params=None):
    """Linear-classifier accuracy on z_diff (reference utils.py:156-174)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import accuracy_score
    from sklearn.preprocessing import StandardScaler

    params = params or {}
    lr_params = params.get("bvae_lr_params", {})
    if params.get("scale"):
        scl = StandardScaler()
        x_train = scl.fit_transform(x_train)
        x_test = scl.transform(x_test)
    clf = LogisticRegression(**lr_params)
    clf.fit(x_train, y_train)
    return accuracy_score(y_test, clf.predict(x_test), normalize=True)


# ---------------------------------------------------------------------------
# DCI
# ---------------------------------------------------------------------------

def _resolve_informativeness_estimator(params: dict):
    from sklearn.ensemble import GradientBoostingClassifier, RandomForestClassifier

    method = params.get("informativeness_method")
    estimator_params = dict(params.get("informativeness_params", {}))
    if method == "xgb":
        try:
            from xgboost import XGBClassifier

            if not hasattr(XGBClassifier, "fit"):  # stubbed module
                raise ImportError("xgboost stub")
            # CUDA-only knobs from the reference config are normalized to
            # portable ones (quirk Q13).
            estimator_params.pop("gpu_id", None)
            if estimator_params.get("tree_method") == "gpu_hist":
                estimator_params["tree_method"] = "hist"
            estimator_params.pop("use_label_encoder", None)
            return XGBClassifier, estimator_params
        except ImportError:
            return RandomForestClassifier, {}
    if method == "rf":
        return RandomForestClassifier, estimator_params
    return GradientBoostingClassifier, estimator_params


def fit_info_clf(x_train, y_train, x_test, y_test, params=None):
    """Per-factor classifier fit -> (train acc, test acc, |importance| matrix P).

    Reference: evaluation/utils.py:178-217.
    """
    from sklearn.metrics import accuracy_score

    params = params or {}
    estimator, estimator_params = _resolve_informativeness_estimator(params)

    y_train = y_train.astype(int)
    y_test = y_test.astype(int)
    train_accs, test_accs, importances = [], [], []
    for i in range(y_train.shape[1]):
        clf = estimator(**estimator_params)
        clf.fit(x_train, y_train[:, i])
        train_accs.append(accuracy_score(y_train[:, i], clf.predict(x_train)))
        test_accs.append(accuracy_score(y_test[:, i], clf.predict(x_test)))
        importances.append(np.abs(clf.feature_importances_))
    return np.mean(train_accs), np.mean(test_accs), np.array(importances)


def compute_disentanglement(P: np.ndarray) -> float:
    """Latent-wise 1 - entropy of importance, weighted (utils.py:220-229)."""
    D = 1.0 - ops.entropy(P, base=P.shape[0])
    if np.sum(P) == 0:
        P = np.ones_like(P)
    ro = np.sum(P, axis=0) / P.sum()
    return float(np.sum(ro * D))


def compute_completeness(P: np.ndarray) -> float:
    """Factor-wise 1 - entropy of importance, weighted (utils.py:232-241)."""
    C = 1.0 - ops.entropy(P.T, base=P.shape[1])
    if np.sum(P) == 0:
        P = np.ones_like(P)
    ro = np.sum(P, axis=1) / P.sum()
    return float(np.sum(ro * C))


# ---------------------------------------------------------------------------
# MIG
# ---------------------------------------------------------------------------

def discretize(x: np.ndarray, bins: int) -> np.ndarray:
    """Histogram-discretize each column (reference utils.py:245-253)."""
    if len(x.shape) == 1:
        x = np.expand_dims(x, axis=0)
    out = np.zeros(x.shape)
    for i in range(x.shape[1]):
        _, bin_edges = np.histogram(x[:, i], bins)
        out[:, i] = np.digitize(x[:, i], bin_edges[:-1])
    return out


def _dense_codes(columns: np.ndarray) -> Tuple[np.ndarray, int]:
    """Recode every column of a discrete-valued [n, d] array to 0..K-1."""
    codes = np.empty(columns.shape, dtype=np.int64)
    k = 1
    for i in range(columns.shape[1]):
        _, codes[:, i] = np.unique(columns[:, i], return_inverse=True)
    if codes.size:
        k = int(codes.max()) + 1
    return codes, k


def calculate_mutual_info(z: np.ndarray, v: np.ndarray) -> np.ndarray:
    """MI (nats) between every latent column and every factor column.

    Parity surface of reference evaluation/utils.py:256-264, which calls
    ``sklearn.mutual_info_score`` per (latent, factor) pair — O(dz·dv)
    passes over the data. Here one ``bincount`` per factor builds the
    joint contingency of that factor against ALL latents at once and the
    plug-in estimate Σ p_ab·log(p_ab/(p_a·p_b)) is evaluated vectorized;
    equality with sklearn is pinned by tests/test_evaluation.py and
    tests/test_torch_evaluation.py.
    """
    n, dz = z.shape
    dv = v.shape[1]
    if n == 0 or dz == 0 or dv == 0:
        return np.zeros([dz, dv])
    zc, kz = _dense_codes(z)
    vc, kv = _dense_codes(v)
    lane = np.arange(dz, dtype=np.int64)[None, :] * (kz * kv)
    mi = np.empty((dz, dv))
    for j in range(dv):
        flat = lane + zc * kv + vc[:, j:j + 1]
        joint = np.bincount(flat.ravel(), minlength=dz * kz * kv)
        joint = joint.reshape(dz, kz, kv).astype(np.float64)
        pz = joint.sum(axis=2, keepdims=True)          # [dz, kz, 1]
        pv = joint.sum(axis=1, keepdims=True)          # [dz, 1, kv]
        with np.errstate(divide="ignore", invalid="ignore"):
            contrib = joint * (np.log(joint * n) - np.log(pz * pv))
        mi[:, j] = np.where(joint > 0, contrib, 0.0).sum(axis=(1, 2)) / n
    # the plug-in estimate is >= 0; clip float residue like sklearn does
    return np.clip(mi, 0.0, None)


def calculate_entropy(v: np.ndarray) -> np.ndarray:
    """Per-factor entropy H(v_j), computed as I(v_j; v_j) exactly like the
    reference (utils.py:267-273) — the diagonal of the MI matrix."""
    return np.array(
        [calculate_mutual_info(v[:, j:j + 1], v[:, j:j + 1])[0, 0]
         for j in range(v.shape[1])]
    )


# ---------------------------------------------------------------------------
# Modularity / Explicitness
# ---------------------------------------------------------------------------

def get_valid_indices(y_train, y_test):
    """Keep only labels present in both splits (utils.py:277-282)."""
    labels = np.array(list(set(y_train) & set(y_test)))
    train_idx = [y in labels for y in y_train]
    test_idx = [y in labels for y in y_test]
    return train_idx, test_idx


def compute_explicitness(x_train, y_train, x_test, y_test, params=None):
    """Mean one-vs-rest ROC-AUC per factor (reference utils.py:285-320)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score
    from sklearn.preprocessing import MultiLabelBinarizer

    params = params or {}
    lr_params = params.get("explicitness_lr_params", {})
    train_aucs, test_aucs = [], []
    for i in range(y_train.shape[1]):
        y_train_i = y_train[:, i].astype(int)
        y_test_i = y_test[:, i].astype(int)
        train_idx, test_idx = get_valid_indices(y_train_i, y_test_i)
        x_train_i, y_train_i = x_train[train_idx, :], y_train_i[train_idx]
        x_test_i, y_test_i = x_test[test_idx, :], y_test_i[test_idx]

        clf = LogisticRegression(**lr_params)
        clf.fit(x_train_i, y_train_i)

        mlb = MultiLabelBinarizer()
        y_train_enc = mlb.fit_transform(y_train_i.reshape(-1, 1))
        y_test_enc = mlb.transform(y_test_i.reshape(-1, 1))
        train_aucs.append(roc_auc_score(y_train_enc, clf.predict_proba(x_train_i)))
        test_aucs.append(roc_auc_score(y_test_enc, clf.predict_proba(x_test_i)))
    return np.mean(train_aucs), np.mean(test_aucs)


def compute_modularity(mi: np.ndarray) -> float:
    """Deviation of the MI matrix from a one-hot template (utils.py:323-335)."""
    num_latents, n = mi.shape
    template = np.zeros_like(mi)
    max_mi_idx = np.argmax(mi, axis=1)
    thetas = np.max(mi, axis=1)
    template[range(num_latents), max_mi_idx] = thetas
    deltas = np.sum((mi - template) ** 2, axis=1) / (thetas**2 * (n - 1))
    return float(np.mean(1 - deltas))
