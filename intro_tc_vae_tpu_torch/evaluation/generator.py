"""Ground-truth-factor sampling for disentanglement metrics.

A copy of ``intro_tc_vae_tpu/evaluation/generator.py`` (numpy only;
importing the JAX package imports jax), so a seeded ``RandomState`` draws
the same factors, index for index, in both packages. Parity surface of
reference evaluation/generator.py:10-156. Observation batches are float32
NHWC numpy arrays; the metrics' ``encode_fn`` moves them to the device
(``solvers/base.py::VAESolver.make_eval_encoder``).
"""

from __future__ import annotations

from typing import Generator, Optional, Tuple

import numpy as np


def _cartesian(arrays):
    """All combinations of the input 1-D arrays, counting fastest on the
    last factor (sklearn.utils.extmath.cartesian ordering)."""
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


class FeatureIndex:
    """Lookup from a factor configuration to the flat dataset index.

    Works when the dataset is laid out with factors as mixed-radix
    counting (most significant factor first); the dot product with the
    factor bases is the place-value expansion.
    Reference: evaluation/generator.py:10-54.
    """

    def __init__(self, factor_sizes, features=None):
        self.factor_sizes = factor_sizes
        self.features = features
        self._num_feature_values = np.prod(self.factor_sizes)
        self.factor_bases = np.divide(
            self._num_feature_values, np.cumprod(self.factor_sizes)
        )
        self._features_to_index = np.arange(self._num_feature_values)

    def _get_feature_space(self, features) -> np.ndarray:
        return np.dot(features, self.factor_bases).astype(np.int32)

    def __len__(self):
        return len(self._features_to_index)

    def __getitem__(self, features):
        return self._features_to_index[self._get_feature_space(features)]

    def keys(self):
        return self._features_to_index

    def values(self):
        return self.features

    def items(self):
        return zip(self.keys(), self.values())


class LatentGenerator:
    """Samples ground-truth factor configurations and their observations.

    Reference: evaluation/generator.py:57-156. ``data_source`` must expose
    latent_indices / factor_sizes / __getitem__ (and ideally get_batch for
    a vectorized gather).
    """

    def __init__(self, data_source, seed: Optional[int] = None):
        self.data_source = data_source
        self.latent_indices = list(data_source.latent_indices)
        self.factor_sizes = list(data_source.factor_sizes)

        self.num_factors = len(self.factor_sizes)
        self.num_latents = len(self.latent_indices)

        self.observed_factor_indices = [
            i for i in range(self.num_factors) if i not in self.latent_indices
        ]
        self.num_observed_factors = len(self.observed_factor_indices)

        self.features = self._get_features()
        self.feature_lookup = FeatureIndex(self.factor_sizes, self.features)

        self.seed = seed
        self.random_state = np.random.RandomState(seed)

    def _get_features(self) -> np.ndarray:
        return _cartesian([np.arange(i) for i in self.factor_sizes])

    def sample_factors_of_variation(self, batch_size: int) -> np.ndarray:
        """[batch, num_latents] uniform draws, vectorized over columns."""
        highs = np.asarray([self.factor_sizes[i] for i in self.latent_indices])
        return self.random_state.randint(
            highs, size=(batch_size, self.num_latents)
        ).astype(np.float64)

    def sample_all_factors(self, latent_factors: np.ndarray) -> np.ndarray:
        """Fill any non-varied ('observed') factor columns with uniform
        draws (reference generator.py:99-130), vectorized."""
        if self.num_observed_factors == 0:
            return latent_factors
        num_samples = len(latent_factors)
        all_factors = np.zeros((num_samples, self.num_factors))
        all_factors[:, self.latent_indices] = latent_factors
        obs = self.observed_factor_indices
        highs = np.asarray([self.factor_sizes[i] for i in obs])
        all_factors[:, obs] = self.random_state.randint(
            highs, size=(num_samples, len(obs))
        )
        return all_factors

    def sample_observations_from_factors(self, factors: np.ndarray) -> np.ndarray:
        """Factor batch -> float32 [B, H, W, C] observation batch."""
        all_factors = self.sample_all_factors(factors)
        indices = self.feature_lookup[all_factors]
        if hasattr(self.data_source, "get_batch"):
            return self.data_source.get_batch(indices)
        return np.stack([self.data_source[i][0] for i in indices], axis=0)

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        factors = self.sample_factors_of_variation(batch_size)
        observations = self.sample_observations_from_factors(factors)
        return factors, observations

    def generate(
        self, n_samples: int = 1000, batch_size: int = 64, drop_last: bool = False
    ) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
        batches = [batch_size] * (n_samples // batch_size)
        if not drop_last and n_samples % batch_size != 0:
            batches.append(n_samples % batch_size)
        for b in batches:
            yield self.sample(batch_size=b)

    def _sample_factors(self, idx, size):
        return self.random_state.randint(self.factor_sizes[idx], size=size)
