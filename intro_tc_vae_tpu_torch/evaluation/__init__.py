"""Disentanglement evaluation: ground-truth-factor sampling + 4 metric
families (beta-VAE score, DCI, MIG, Modularity/Explicitness) and FID.

Counterpart of ``intro_tc_vae_tpu/evaluation/`` (generator.py,
metrics.py, utils.py, fid.py; parity surface of reference evaluation/).
The metrics consume an ``encode_fn(images) -> (mu, logvar)`` over the
port's eval-mode encoder on the device
(``solvers/base.py::VAESolver.make_eval_encoder``). The classifiers are
scikit-learn's, imported only where a score fits one, so the package
imports and MIG and modularity compute on a host without sklearn; the DCI
informativeness classifier is xgboost's where it imports, else sklearn's
(quirk Q13).
"""

from intro_tc_vae_tpu_torch.evaluation.generator import FeatureIndex, LatentGenerator
from intro_tc_vae_tpu_torch.evaluation.metrics import (
    compute_bvae_score,
    compute_dci_score,
    compute_mig_score,
    compute_mod_expl_score,
    write_bvae_score,
    write_dci_score,
    write_mig_score,
    write_mod_expl_score,
)

__all__ = [
    "FeatureIndex",
    "LatentGenerator",
    "compute_bvae_score",
    "compute_dci_score",
    "compute_mig_score",
    "compute_mod_expl_score",
    "write_bvae_score",
    "write_dci_score",
    "write_mig_score",
    "write_mod_expl_score",
]
