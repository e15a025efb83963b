"""PyTorch port, FID (``intro_tc_vae_tpu_torch/evaluation/fid.py``) and the
InceptionV3-pool3 network (``models/inception.py``) against the JAX
package's, on the CPU.

* ``frechet_distance`` on the closed-form cases of tests/test_fid.py, and
  equal to the JAX function on random moments; ``compute_fid`` and the
  encoder-feature FID equal to JAX's on the same features / weights.
* ``standard_fid`` returns None without a local weights file, and
  ``find_weights`` resolves argument > $ITCVAE_INCEPTION_WEIGHTS > the
  cache path. Nothing is downloaded.
* InceptionV3: a random-valued state_dict (He-scaled convs, BN statistics
  around 1) saved with ``torch.save`` is loaded by the JAX
  ``load_torch_inception_weights`` and by the port's
  ``load_inception_weights``; the pool3 features agree at 75x75 (no
  resize), 64x64 (upsampled to 299) and 320x320 (downsampled, with
  antialiasing) in float32 within rtol 1e-4 plus an atol of 1e-5 of the
  largest feature (measured: about 1e-6 of the largest; the relative
  error of features near 0 is meaningless in float32 after 94 layers).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu.evaluation import fid as jfid
from intro_tc_vae_tpu_torch.evaluation import fid
from intro_tc_vae_tpu_torch.models import inception
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------

def test_identical_distributions_zero():
    mu = np.array([1.0, 2.0])
    cov = np.array([[2.0, 0.3], [0.3, 1.0]])
    assert fid.frechet_distance(mu, cov, mu, cov) == pytest.approx(0.0, abs=1e-4)


def test_mean_shift_closed_form():
    """Same covariance, shifted mean: d^2 = |dmu|^2."""
    cov = np.eye(3)
    d = fid.frechet_distance(np.zeros(3), cov, np.array([3.0, 0, 0]), cov)
    assert d == pytest.approx(9.0, rel=1e-4)


def test_isotropic_scale_closed_form():
    """N(0, a^2 I) vs N(0, b^2 I): d^2 = D*(a-b)^2."""
    d = fid.frechet_distance(np.zeros(2), 4.0 * np.eye(2), np.zeros(2), np.eye(2))
    assert d == pytest.approx(2 * (2.0 - 1.0) ** 2, rel=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_frechet_distance_equals_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(5, 5), rng.randn(5, 5)
    mu1, mu2 = rng.randn(5), rng.randn(5)
    d12 = fid.frechet_distance(mu1, a @ a.T, mu2, b @ b.T)
    assert d12 == pytest.approx(fid.frechet_distance(mu2, b @ b.T, mu1, a @ a.T), rel=1e-6)
    assert d12 == jfid.frechet_distance(mu1, a @ a.T, mu2, b @ b.T)
    feats = rng.randn(100, 6)
    for got, want in zip(fid.gaussian_moments(feats), jfid.gaussian_moments(feats)):
        np.testing.assert_array_equal(got, want)


def test_compute_fid_equals_jax_and_orders_quality():
    rng = np.random.RandomState(0)

    def feature_fn(images):
        return images.reshape(len(images), -1)[:, :8]

    real = rng.rand(200, 4, 4, 1).astype(np.float32)
    near = real + rng.randn(*real.shape).astype(np.float32) * 0.01
    far = rng.rand(200, 4, 4, 1).astype(np.float32) * 3.0
    assert fid.compute_fid(feature_fn, real, real.copy()) == pytest.approx(0.0, abs=1e-6)
    assert fid.compute_fid(feature_fn, real, near) < fid.compute_fid(feature_fn, real, far)
    assert fid.compute_fid(feature_fn, real, far, batch_size=64) == \
        jfid.compute_fid(feature_fn, real, far, batch_size=64)


def test_encoder_fid_equals_jax():
    """Encoder-feature FID and features in both packages on the same
    float64 encoder weights (tests/test_torch_evaluation.py's fixture):
    the fp32 latents are bit-equal, so the distances are equal."""
    from tests.test_torch_evaluation import _pair

    import jax
    import jax.numpy as jnp

    from intro_tc_vae_tpu.models import Decoder as JDecoder
    from intro_tc_vae_tpu.models import Encoder as JEncoder
    from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
    from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.models import conv_output_size
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
    from intro_tc_vae_tpu_torch.utils import flax_to_port

    ours, theirs = _pair("synthetic", None, None)
    kw = dict(arch="conv", cdim=1, zdim=6, channels=(8, 16), image_size=16)
    jsolver = jmake_solver("vae", dataset=theirs, encoder=JEncoder(**kw),
                           decoder=JDecoder(**kw), batch_size=16,
                           optimizer_e=jmake_optimizer("adam", 1e-3),
                           optimizer_d=jmake_optimizer("adam", 1e-3))
    state = jsolver.init_state(jax.random.key(1), jnp.zeros((1, 16, 16, 1)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), state.params)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), state.batch_stats)
    enc = Encoder(**kw, compute_dtype=torch.float64)
    dec = Decoder(**kw, compute_dtype=torch.float64)
    model = SoftIntroVAE(enc, dec).to(torch.float64)
    model.load_state_dict(flax_to_port(params, stats, "conv", conv_output_size(16, (8, 16))))
    solver = make_solver("vae", dataset=ours, encoder=enc, decoder=dec, batch_size=16,
                         optimizer_e=make_optimizer("adam", 1e-3),
                         optimizer_d=make_optimizer("adam", 1e-3))
    pstate = solver.init_state(0)

    real = ours.get_batch(np.arange(0, 128, 2))
    fake = np.clip(real + np.random.RandomState(2).rand(*real.shape).astype(np.float32)
                   * 0.3, 0, 1)
    with jax.enable_x64(True):
        jstate = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                               batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        want = jfid.encoder_fid(jsolver, jstate, real, fake, batch_size=16)
        want_feats = jfid.encoder_features(jsolver, jstate, real, batch_size=16)
    got_feats = fid.encoder_features(solver, pstate, real, batch_size=16)
    np.testing.assert_array_equal(got_feats, want_feats)
    assert fid.encoder_fid(solver, pstate, real, fake, batch_size=16) == want > 0


def test_standard_fid_is_none_without_weights(monkeypatch, tmp_path):
    """No local weights: standard_fid returns None (no download), and
    find_weights resolves argument, then the environment, then the cache."""
    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(inception, "DEFAULT_WEIGHTS", str(tmp_path / "none.pth"))
    imgs = np.zeros((4, 8, 8, 3), np.float32)
    assert fid.standard_fid(imgs, imgs, device=CPU) is None
    assert inception.inception_feature_fn(device=CPU) is None
    arg, env, cache = (tmp_path / n for n in ("arg.pth", "env.pth", "cache.pth"))
    for p in (arg, env, cache):
        p.write_bytes(b"")
    monkeypatch.setattr(inception, "DEFAULT_WEIGHTS", str(cache))
    assert inception.find_weights() == str(cache)
    monkeypatch.setenv(inception.WEIGHTS_ENV, str(env))
    assert inception.find_weights() == str(env)
    assert inception.find_weights(str(arg)) == str(arg)
    assert inception.find_weights(str(tmp_path / "missing.pth")) == str(env)


# ---------------------------------------------------------------------------
# InceptionV3-pool3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A random-valued InceptionV3 state_dict on disk, torchvision names,
    with the fc and AuxLogits entries a torchvision file carries."""
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in inception.InceptionV3Features().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            val = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith(("bn.weight", "running_var")):
            val = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("bn.bias", "running_mean")):
            val = rng.uniform(-0.2, 0.2, shape)
        else:
            sd[k] = v
            continue
        sd[k] = torch.from_numpy(val.astype(np.float32))
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    path = tmp_path_factory.mktemp("inception") / "inception_v3.pth"
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("size,resize", [(75, False), (64, True), (320, True)],
                         ids=["75-no-resize", "64-upsample", "320-antialiased-downsample"])
def test_pool3_features_equal_jax(weights, size, resize):
    import jax.numpy as jnp

    from intro_tc_vae_tpu.models.inception import InceptionV3Features as JInception
    from intro_tc_vae_tpu.models.inception import load_torch_inception_weights

    params, stats = load_torch_inception_weights(weights)
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(JInception(resize_input=resize).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = inception.load_inception_weights(
        inception.InceptionV3Features(resize_input=resize), weights).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 320])
def test_resize_equals_jax_image_resize(size):
    """The input resize alone: half-pixel bilinear, antialiased when it
    downsamples, equals ``jax.image.resize(..., "bilinear")`` to float32
    rounding (rtol 1e-4: the two compute the antialiasing weights in
    float32 each its own way); without antialiasing the 320 -> 299
    downsample would not."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.interpolate(xt, size=(299, 299), mode="bilinear", align_corners=False,
                        antialias=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    plain = F.interpolate(xt, size=(299, 299), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    assert (np.abs(plain - want).max() > 1e-2) == (size > 299)


def test_feature_fn_and_weights_loading(weights, tmp_path):
    """``inception_feature_fn`` on the CPU: NHWC numpy in, the model's
    features out; a grey image is the same image repeated on 3 channels;
    a state_dict that misses a tensor is refused."""
    fn = inception.inception_feature_fn(weights, device=CPU)
    model = inception.load_inception_weights(inception.InceptionV3Features(), weights).eval()
    grey = np.random.RandomState(5).rand(2, 40, 40, 1).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(np.repeat(grey, 3, axis=-1)).permute(0, 3, 1, 2))
    want = want.numpy()  # the memory layouts differ, so oneDNN sums in its own order
    np.testing.assert_allclose(fn(grey), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    sd = torch.load(weights, weights_only=True)
    del sd["Mixed_7c.branch_pool.conv.weight"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.conv.weight"):
        inception.load_inception_weights(inception.InceptionV3Features(),
                                         str(tmp_path / "partial.pth"))
    assert fid.standard_fid(grey, grey, batch_size=2, weights_path=weights,
                            device=CPU) == pytest.approx(0.0, abs=1e-3)
