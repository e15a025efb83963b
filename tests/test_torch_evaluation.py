"""PyTorch port, the evaluation layer (``intro_tc_vae_tpu_torch/evaluation/``,
``ops.entropy``) against the JAX package's, on the CPU.

* ``LatentGenerator`` / ``FeatureIndex``: the same seed draws the same
  factors and observations, index for index, on the dSprites- and
  MPI3D-layout fixtures of tests/test_torch_data.py and on Synthetic.
* Every score of the four metric families equals the JAX package's to
  abs 1e-9: both encoders run in float64 (JAX in x64 mode) on the same
  weights (JAX init carried across by ``flax_to_port``), from generators
  with the same seed; the classifiers get a fixed ``random_state``.
* The helpers (``calculate_mutual_info`` against sklearn's
  ``mutual_info_score``, ``entropy``, ``discretize``, the DCI and
  modularity reductions) against the JAX package's.
* Import hygiene: the port's evaluation modules import neither jax, the
  JAX package, sklearn, matplotlib nor a TensorBoard package.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu import ops as jops
from intro_tc_vae_tpu.data import datasets as jdatasets
from intro_tc_vae_tpu.evaluation import FeatureIndex as JFeatureIndex
from intro_tc_vae_tpu.evaluation import LatentGenerator as JLatentGenerator
from intro_tc_vae_tpu.evaluation import metrics as jmetrics
from intro_tc_vae_tpu.evaluation import utils as jutils
from intro_tc_vae_tpu.models import Decoder as JDecoder
from intro_tc_vae_tpu.models import Encoder as JEncoder
from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
from intro_tc_vae_tpu_torch import ops
from intro_tc_vae_tpu_torch.data import datasets
from intro_tc_vae_tpu_torch.evaluation import FeatureIndex, LatentGenerator
from intro_tc_vae_tpu_torch.evaluation import metrics, utils
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE, conv_output_size
from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
from intro_tc_vae_tpu_torch.utils import flax_to_port
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_data import assert_path
from tests.test_torch_data import dsprites_root, mpi3d_root, same_path  # noqa: F401  (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 1e-9


def _pair(name, dsprites_root, mpi3d_root, resize=None):
    """(port dataset, JAX dataset) of ``name``; the array datasets at
    ``resize`` (their stored size keeps the fixtures cheap)."""
    if name.startswith("synthetic"):
        return (datasets.Synthetic(image_size=16, cdim=1, sizes=(3, 3, 4, 4)),
                jdatasets.Synthetic(image_size=16, cdim=1, sizes=(3, 3, 4, 4)))
    root = dsprites_root if name.startswith("dsprites") else mpi3d_root
    ours, *_ = datasets.load_dataset(name, data_root=root)
    theirs, *_ = jdatasets.load_dataset(name, data_root=root)
    if resize is not None:
        ours.resize = theirs.resize = resize
    return ours, theirs


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dsprites_small", "dsprites", "mpi3d_small", "synthetic"])
def test_latent_generator_draws_equal_jax(name, dsprites_root, mpi3d_root, same_path):
    """Seeded generators of both packages: the same factors, the same
    observation batches, batch for batch, through ``sample`` and
    ``generate`` (a ragged last batch included). The stored dSprites and
    MPI3D images are resized to 64 on the way: both packages on one resize
    path (``same_path``)."""
    ours, theirs = _pair(name, dsprites_root, mpi3d_root)
    a, b = LatentGenerator(ours, seed=3), JLatentGenerator(theirs, seed=3)
    assert (a.num_factors, a.num_latents, a.observed_factor_indices) == \
           (b.num_factors, b.num_latents, b.observed_factor_indices)
    np.testing.assert_array_equal(a.features, b.features)
    for _ in range(2):
        (fa, oa), (fb, ob) = a.sample(12), b.sample(12)
        np.testing.assert_array_equal(fa, fb)
        assert oa.dtype == np.float32 and oa.shape[0] == 12
        np.testing.assert_array_equal(oa, ob)
    got = list(a.generate(n_samples=20, batch_size=8))
    want = list(b.generate(n_samples=20, batch_size=8))
    assert [len(f) for f, _ in got] == [len(f) for f, _ in want] == [8, 8, 4]
    for (fa, oa), (fb, ob) in zip(got, want):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(oa, ob)
    np.testing.assert_array_equal(a._sample_factors(1, 5), b._sample_factors(1, 5))
    assert_path(same_path)


def test_observed_factors_are_filled_like_jax():
    """A dataset with a factor that is not a latent (an 'observed' one):
    ``sample_all_factors`` draws it from the same stream in both."""
    class Partial(datasets.Synthetic):
        latent_indices = property(lambda self: [0, 2, 3])

    class JPartial(jdatasets.Synthetic):
        latent_indices = property(lambda self: [0, 2, 3])

    a = LatentGenerator(Partial(image_size=8, cdim=1, sizes=(2, 3, 4, 4)), seed=1)
    b = JLatentGenerator(JPartial(image_size=8, cdim=1, sizes=(2, 3, 4, 4)), seed=1)
    assert a.observed_factor_indices == b.observed_factor_indices == [1]
    for _ in range(3):
        fa, fb = a.sample_factors_of_variation(10), b.sample_factors_of_variation(10)
        np.testing.assert_array_equal(a.sample_all_factors(fa), b.sample_all_factors(fb))


def test_feature_index_equals_jax():
    sizes = [1, 3, 6, 4, 10, 10]
    a, b = FeatureIndex(sizes), JFeatureIndex(sizes)
    rng = np.random.RandomState(0)
    feats = np.stack([rng.randint(0, s, 50) for s in sizes], axis=1)
    assert len(a) == len(b) == 7200
    np.testing.assert_array_equal(a[feats], b[feats])
    np.testing.assert_array_equal(a.factor_bases, b.factor_bases)


# ---------------------------------------------------------------------------
# the four families, in float64 on the same weights
# ---------------------------------------------------------------------------

WIDTHS = (8, 16)
ZDIM = 8


def _cycling(cls):
    """``cls`` whose ``seed`` advances each time it is read. Quirk Q14: the
    beta-VAE batch re-seeds ``RandomState(generator.seed)`` at every call,
    so a fixed seed picks one factor for every batch and the classifier
    sees one class; this keeps the draws reproducible in both packages and
    the labels varied, and leaves the quirk as it is."""
    class Cycling(cls):
        @property
        def seed(self):
            self._reads += 1
            return self._seed + self._reads

        @seed.setter
        def seed(self, value):
            self._seed, self._reads = value, 0

    return Cycling


@pytest.fixture(scope="module")
def encoders(dsprites_root):
    """(port encode_fn, JAX encode_fn, port dataset, JAX dataset): the same
    float64 encoder weights and BatchNorm statistics (random, so eval mode
    normalizes with something other than 0 / 1) on dSprites-small stored
    at 8x8."""
    ours, theirs = _pair("dsprites_small", dsprites_root, None, resize=8)
    kw = dict(arch="conv", cdim=1, zdim=ZDIM, channels=WIDTHS, image_size=8)
    jsolver = jmake_solver("vae", dataset=theirs, encoder=JEncoder(**kw),
                           decoder=JDecoder(**kw), batch_size=16,
                           optimizer_e=jmake_optimizer("adam", 1e-3),
                           optimizer_d=jmake_optimizer("adam", 1e-3))
    state = jsolver.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), state.params)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape) if a.ndim else a, state.batch_stats)

    with jax.enable_x64(True):
        jstate = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                               batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        jencode = jsolver.make_eval_encoder(jstate)

        def jax_encode(x):
            with jax.enable_x64(True):
                return jencode(x)

    enc = Encoder(**kw, compute_dtype=torch.float64)
    dec = Decoder(**kw, compute_dtype=torch.float64)
    model = SoftIntroVAE(enc, dec).to(torch.float64)
    model.load_state_dict(flax_to_port(params, stats, "conv", conv_output_size(8, WIDTHS)))
    solver = make_solver("vae", dataset=ours, encoder=enc, decoder=dec, batch_size=16,
                         optimizer_e=make_optimizer("adam", 1e-3),
                         optimizer_d=make_optimizer("adam", 1e-3))
    return solver.make_eval_encoder(solver.init_state(0)), jax_encode, ours, theirs


def test_eval_encoders_agree(encoders):
    """The two float64 encoders' fp32 latents are bit-equal on a batch
    (both cast mu/logvar to fp32), and the port's module stays in train
    mode after the eval-mode pass."""
    encode, jencode, ours, _ = encoders
    x = ours.get_batch(np.arange(0, 7200, 300))
    (mu, logvar), (jmu, jlogvar) = encode(x), jencode(x)
    assert mu.dtype == np.float32 and mu.shape == (24, ZDIM)
    np.testing.assert_array_equal(mu, np.asarray(jmu))
    np.testing.assert_array_equal(logvar, np.asarray(jlogvar))
    assert np.std(mu, axis=0).min() > 0


N_SAMPLES = 200
SAGA = {"solver": "saga", "max_iter": 300, "random_state": 0}
SCORES = {
    "bvae": ("compute_bvae_score", {}),
    "dci_gbc": ("compute_dci_score", dict(params=dict(
        informativeness_method="gbc",
        informativeness_params=dict(n_estimators=20, random_state=0)))),
    "dci_rf": ("compute_dci_score", dict(params=dict(
        informativeness_method="rf", informativeness_params=dict(random_state=0)))),
    "mig": ("compute_mig_score", {}),
    "mod_expl": ("compute_mod_expl_score", dict(params=dict(explicitness_lr_params=SAGA))),
}


@pytest.mark.parametrize("score", sorted(SCORES))
def test_scores_equal_jax(score, encoders):
    """Each family's scores from both packages, from seeded generators
    (beta-VAE: ``_cycling``) and the same float64 encoder weights: equal
    to abs 1e-9. DCI with sklearn's GradientBoostingClassifier and
    RandomForestClassifier, each with random_state 0; explicitness with
    saga, random_state 0 (JAX's write_* parameters plus the seed)."""
    encode, jencode, ours, theirs = encoders
    fn, kw = SCORES[score]
    cls, jcls = (_cycling(LatentGenerator), _cycling(JLatentGenerator)) \
        if score == "bvae" else (LatentGenerator, JLatentGenerator)
    got = getattr(metrics, fn)(cls(ours, seed=11), encode, num_samples=N_SAMPLES,
                               batch_size=20, **kw)
    want = getattr(jmetrics, fn)(jcls(theirs, seed=11), jencode, num_samples=N_SAMPLES,
                                 batch_size=20, **kw)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    if score == "bvae":  # not the degenerate single-class draw
        assert 0.0 <= got.min() and got.max() <= 1.0


def test_mod_expl_hands_modularity_over_before_explicitness(encoders):
    """``scores`` receives modularity before explicitness runs: a failing
    explicitness (here a bad solver name) leaves it there, as
    ``write_mod_expl_score`` writes it where sklearn is absent."""
    encode, _, ours, _ = encoders
    scores = {}
    with pytest.raises(ValueError):
        metrics.compute_mod_expl_score(
            LatentGenerator(ours, seed=2), encode, num_samples=60, batch_size=20,
            params=dict(explicitness_lr_params={"solver": "no-such-solver"}), scores=scores)
    assert list(scores) == ["modularity_score"] and 0.0 <= scores["modularity_score"] <= 1.0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", [None, 5])
@pytest.mark.parametrize("axis", [0, 1])
def test_entropy_equals_jax(base, axis):
    p = np.random.RandomState(base or 0).rand(5, 7)
    np.testing.assert_array_equal(ops.entropy(p, base=base, axis=axis),
                                  jops.entropy(p, base=base, axis=axis))
    with pytest.raises(TypeError):
        ops.entropy([0.5, 0.5])


def test_calculate_mutual_info_matches_sklearn_and_jax():
    from sklearn.metrics import mutual_info_score

    rng = np.random.RandomState(7)
    z = utils.discretize(rng.randn(500, 6), bins=10)
    v = rng.randint(0, 4, size=(500, 3))
    got = utils.calculate_mutual_info(z, v)
    want = np.array([[mutual_info_score(z[:, i], v[:, j]) for j in range(3)]
                     for i in range(6)])
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_array_equal(got, jutils.calculate_mutual_info(z, v))
    np.testing.assert_array_equal(utils.calculate_entropy(v), jutils.calculate_entropy(v))
    assert utils.calculate_mutual_info(z[:0], v[:0]).shape == (6, 3)


def test_reductions_equal_jax():
    """discretize, the DCI reductions, modularity and the valid-label split
    on the same random inputs."""
    rng = np.random.RandomState(1)
    x = rng.randn(200, 4)
    np.testing.assert_array_equal(utils.discretize(x, 20), jutils.discretize(x, 20))
    np.testing.assert_array_equal(utils.discretize(x[:, 0], 5),
                                  jutils.discretize(x[:, 0], 5))
    for P in (rng.rand(5, 8), np.zeros((5, 8))):
        assert utils.compute_disentanglement(P) == jutils.compute_disentanglement(P)
        assert utils.compute_completeness(P) == jutils.compute_completeness(P)
    mi = rng.rand(8, 5)
    assert utils.compute_modularity(mi) == jutils.compute_modularity(mi)
    y_train, y_test = rng.randint(0, 6, 40), rng.randint(1, 8, 40)
    assert utils.get_valid_indices(y_train, y_test) == jutils.get_valid_indices(y_train,
                                                                                y_test)


@pytest.mark.parametrize("method", ["xgb", "rf", "gbc"])
def test_informativeness_estimator_resolves_like_jax(method):
    """Without xgboost (neither host has it) 'xgb' falls back to a random
    forest with default parameters; 'rf' keeps its parameters."""
    params = dict(informativeness_method=method,
                  informativeness_params=dict(tree_method="hist", eval_metric="mlogloss")
                  if method == "xgb" else dict(random_state=0))
    cls, kw = utils._resolve_informativeness_estimator(params)
    jcls, jkw = jutils._resolve_informativeness_estimator(params)
    assert (cls, kw) == (jcls, jkw)


def test_evaluation_imports_no_optional_package():
    """Importing the evaluation layer, the evaluate CLI, the TensorBoard
    reader and writer, the Inception module and the trainer loads no jax,
    JAX-package, sklearn, matplotlib or TensorBoard module."""
    code = """
import sys
import intro_tc_vae_tpu_torch.evaluation, intro_tc_vae_tpu_torch.evaluate
import intro_tc_vae_tpu_torch.utils.tb_reader, intro_tc_vae_tpu_torch.evaluation.fid
import intro_tc_vae_tpu_torch.models.inception, intro_tc_vae_tpu_torch.train
roots = ("jax", "jaxlib", "flax", "intro_tc_vae_tpu", "sklearn", "matplotlib",
         "tensorboardX", "tensorboard", "tensorflow", "pandas")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in roots or n.startswith("torch.utils.tensorboard"))
print(bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
