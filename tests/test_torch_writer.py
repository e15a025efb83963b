"""PyTorch port, TensorBoard writing and reading (``utils/writer.py``,
``utils/tb_reader.py``, the solver's observability surface and the
trainer's writer) against the JAX package's, on the CPU.

* ``make_writer`` takes ``torch.utils.tensorboard`` first, tensorboardX
  where that does not import, and raises naming both without either; the
  run directory is ``log_dir + comment``.
* The five repo configs that set ``use_tensorboard`` validate and set up
  in the port at a small size, with the writer made.
* Shrunken ``intro_tc_ukiyo64.json`` and ``tc_dsprites.json`` (dSprites-small
  stored at 8x8, widths [8, 16], z 8, batch 16; 320 rows an epoch, the
  latent generator on the whole 7,200-row grid; 2 epochs, ``test_iter``
  10) trained by both packages with the writer on: the same scalar tags,
  image tags and hparams, each at the same global steps; the port's
  ``tb_reader`` reads the port's run and the JAX run.
* The image grid of both packages on the same weights, batch and prior
  noise: fp32 within the step tests' rtol 1e-4 / atol 1e-5, bf16 within
  tests/_torch_bf16.py's bound.
* Without sklearn (made unimportable in a subprocess): the package
  imports, training with the writer on completes, MIG and modularity are
  written and the sklearn-backed scores print their failure.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.data import datasets as jdatasets
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.data import datasets
from intro_tc_vae_tpu_torch.utils.tb_reader import TensorboardReader
from intro_tc_vae_tpu_torch.utils.writer import SingletonWriter, make_writer
from tests._torch_bf16 import assert_close_bf16, rounded_layers
from tests._torch_threads import one_thread  # noqa: F401  (autouse)
from tests.test_torch_data import dsprites_root  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CONFIGS = {"intro_tc": os.path.join(REPO, "configs", "intro_tc_ukiyo64.json"),
           "tc": os.path.join(REPO, "configs", "tc_dsprites.json")}
TB_CONFIGS = ["intro_tc_ukiyo64.json", "intro_ukiyo64.json", "intro_tc_128_dp8.json",
              "tc_dsprites.json", "vae_dsprites.json"]
EPOCH_ROWS = 320
TINY = dict(dataset="dsprites_small", num_epochs=2, batch_size=16, z_dim=8, lr=1e-3,
            seed=5, test_iter=10, save_interval=10**6, device_cache="off",
            transfer_dtype="float32")


def _dsprites_head(module, root):
    """``load_dataset`` of ``module`` replaced: dSprites-small stored at 8x8,
    targeted there, widths [8, 16]; an epoch is its first EPOCH_ROWS rows
    (``len``), while the latent generator draws from the whole grid
    through ``get_batch``."""
    real = module.load_dataset

    def load(name, data_root=None):
        ds, _, _, cdim = real("dsprites_small", data_root=root)
        ds.resize = 8
        ds.__class__ = type("Head", (type(ds),), {"__len__": lambda self: EPOCH_ROWS})
        return ds, 8, [8, 16], cdim

    return load


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def test_make_writer_takes_torch_utils_tensorboard(tmp_path, monkeypatch):
    w = make_writer(comment="_c", log_dir=str(tmp_path / "tb"))
    try:
        assert type(w).__module__.startswith("torch.utils.tensorboard")
        assert w.log_dir == str(tmp_path / "tb_c")
    finally:
        w.close()
    monkeypatch.chdir(tmp_path)
    w = make_writer(comment="_solver_z8")
    try:
        assert os.path.dirname(w.log_dir) == "runs" and w.log_dir.endswith("_solver_z8")
    finally:
        w.close()


def test_make_writer_falls_back_to_tensorboardx_then_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = make_writer(comment="_x", log_dir=str(tmp_path / "tb"))
    try:
        assert type(w).__module__.startswith("tensorboardX")
    finally:
        w.close()
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="torch.utils.tensorboard.*tensorboardX"):
        make_writer(log_dir=str(tmp_path / "none"))


def test_singleton_writer():
    a, b = SingletonWriter(), SingletonWriter()
    assert a is b
    saved = (a.writer, a.cur_iter, a.test_iter)
    try:
        a.writer, a.cur_iter, a.test_iter = None, 10, 5
        assert not a.write_test_iter
        a.writer = object()
        assert a.write_test_iter
        a.cur_iter = 11
        assert not b.write_test_iter
    finally:
        a.writer, a.cur_iter, a.test_iter = saved


@pytest.mark.parametrize("name", TB_CONFIGS)
def test_tensorboard_configs_set_up(tmp_path, name):
    """Every repo config with ``use_tensorboard: true`` passes validation and
    ``setup`` at the synthetic_small size, and
    rank 0 gets a writer in ``log_dir + run_comment()``."""
    from intro_tc_vae_tpu_torch.train import setup

    config = load_config(os.path.join(REPO, "configs", name),
                         dict(dataset="synthetic_small", batch_size=8, z_dim=8,
                              data_parallel=0, log_dir=str(tmp_path / "tb")))
    assert config.use_tensorboard
    run = setup(config, device=CPU)
    try:
        assert run.writer is not None and run.solver.writer is run.writer
        assert run.solver.test_iter == config.test_iter
        assert run.writer.log_dir == str(tmp_path / "tb") + config.run_comment()
        assert SingletonWriter().writer is run.writer
    finally:
        run.writer.close()
        SingletonWriter().writer = None


# ---------------------------------------------------------------------------
# two trainers, the same shrunken configs, the writer on
# ---------------------------------------------------------------------------

def _events(run_dir):
    """{(sub-run, kind, tag): [global steps]} of every event file under a
    run; the hparams sub-run (named by its time stamp) is '<hparams>'. An
    ``add_scalars`` sub-run is ``{main}_{sub}`` (torch.utils.tensorboard,
    the port's writer) or ``{main}/{sub}`` (tensorboardX, the JAX
    package's): both are read as ``{main}_{sub}``."""
    from tensorboard.backend.event_processing import event_accumulator

    out = {}
    for root, _, files in os.walk(run_dir):
        if not any(f.startswith("events.out") for f in files):
            continue
        sub = os.path.relpath(root, run_dir).replace(os.sep, "_")
        if sub[:1].isdigit():
            sub = "<hparams>"
        ea = event_accumulator.EventAccumulator(
            root, size_guidance={event_accumulator.SCALARS: 0, event_accumulator.IMAGES: 0})
        ea.Reload()
        for kind in ("scalars", "images"):
            for tag in ea.Tags()[kind]:
                events = ea.Scalars(tag) if kind == "scalars" else ea.Images(tag)
                out[(sub, kind, tag)] = sorted(e.step for e in events)
        if sub == "<hparams>":
            out[(sub, "plugin", "hparams")] = sorted(ea.PluginTagToContent("hparams"))
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, dsprites_root, tmp_path_factory):
    """(port run dir, JAX run dir, solver name): the shrunken config
    trained by both packages with the writer on."""
    import intro_tc_vae_tpu.train as T
    from intro_tc_vae_tpu.config import load_config as jload_config
    from intro_tc_vae_tpu_torch import train

    name, path = request.param, CONFIGS[request.param]
    tmp = tmp_path_factory.mktemp(f"tb_{name}")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(train, "load_dataset", _dsprites_head(datasets, dsprites_root))
        mp.setattr(T, "load_dataset", _dsprites_head(jdatasets, dsprites_root))
        update = dict(TINY, use_tensorboard=True)
        config = load_config(path, dict(update, log_dir=str(tmp / "port" / "tb"),
                                        checkpoint_dir=str(tmp / "port_saves")))
        state = train.train_soft_intro_vae(config, device=CPU)
        assert state.step == 2 * EPOCH_ROWS // 16
        jconfig = jload_config(path, dict(update, data_parallel=1,
                                          log_dir=str(tmp / "jax" / "tb"),
                                          checkpoint_dir=str(tmp / "jax_saves")))
        T.train_soft_intro_vae(jconfig)
    finally:
        mp.undo()
        SingletonWriter().writer = None
    port_run, = (tmp / "port").iterdir()
    jax_run, = (tmp / "jax").iterdir()
    assert port_run.name == jax_run.name == "tb" + config.run_comment()
    return port_run, jax_run, name


def test_tags_and_steps_equal_jax(runs):
    """The same scalar, image and hparams entries, each at the same global
    steps: every step's losses at 0..39, the image grid and the four score
    families at the test_iter steps 0, 10, 20, 30 (and the grid after the
    last epoch, at 40), img/s at epochs 0 and 1."""
    port_run, jax_run, name = runs
    got, want = _events(port_run), _events(jax_run)
    assert got == want
    steps = list(range(40))
    losses = ["r_loss", "kl_loss"] + (["expelbo_f"] if name == "intro_tc" else [])
    for tag in losses:
        assert got[(f"losses_{tag}", "scalars", "losses")] == steps
    base = ["kl_loss_unscaled", "r_loss_unscaled", "fc_grad_norm"]
    if name == "intro_tc":
        base += ["lossE", "lossD", "diff_kl"]
    for tag in base:
        assert got[(".", "scalars", tag)] == steps
    heavy = [0, 10, 20, 30]
    assert got[(".", "images", "reconstructions")] == heavy + [40]
    assert got[(".", "scalars", "mig_score")] == heavy
    for sub, tag in [("bvae_score_score", "bvae_score"), ("bvae_score_scaled", "bvae_score"),
                     ("dci_dci_informativeness_score", "dci"),
                     ("dci_dci_completeness_score", "dci"),
                     ("dci_dci_disentanglement_score", "dci"),
                     ("mod_expl_modularity_score", "mod_expl"),
                     ("mod_expl_explicitness_score", "mod_expl")]:
        assert got[(sub, "scalars", tag)] == heavy
    assert got[(".", "scalars", "perf/images_per_sec")] == [0, 1]
    assert got[("<hparams>", "plugin", "hparams")] == [
        "_hparams_/experiment", "_hparams_/session_end_info", "_hparams_/session_start_info"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_reader_reads_both_runs(runs, package):
    """The port's tb_reader on either package's run: the typed accessors,
    the hparams table, the reconstruction images and the fingerprint
    lookup."""
    port_run, jax_run, name = runs
    run = port_run if package == "port" else jax_run
    reader = TensorboardReader(str(run.parent), run.name)
    assert reader.exists
    for df in (reader.r_loss_scaled, reader.kl_loss_scaled, reader.r_loss, reader.kl_loss):
        assert list(df["step"]) == list(range(40)) and np.isfinite(df["value"]).all()
    if name == "intro_tc":
        for df in (reader.loss_e, reader.loss_d, reader.diff_kl, reader.expelbo_f_loss_scaled):
            assert len(df) == 40
    for df in (reader.mig_score, reader.bvae_score, reader.bvae_score_scaled,
               reader.dci_informativeness_score, reader.dci_completeness_score,
               reader.dci_disentanglement_score, reader.modularity_score,
               reader.explicitness_score):
        assert list(df["step"]) == [0, 10, 20, 30] and np.isfinite(df["value"]).all()
    hparams, metrics = reader.hparams
    assert hparams["solver"].string_value == name
    assert hparams["z_dim"].number_value == 8
    assert sorted(metrics) == ["loss_dec", "loss_enc", "loss_kl", "loss_rec"]
    assert all(np.isfinite(v) for v in metrics.values())
    assert len(reader.reconstructions) == 4  # the reservoir keeps the last 4 of 5
    assert min(reader.last_reconstruction.size) >= 8
    found = TensorboardReader.get_reader(str(run.parent), "conv", 4.0 if name == "tc" else 0.5,
                                         1.0 if name == "tc" else 512.0,
                                         1.0 if name == "tc" else 0.75, 1e-08)
    assert found.run_path == run.resolve()


# ---------------------------------------------------------------------------
# the image grid on the same weights and noise
# ---------------------------------------------------------------------------

class _Capture:
    def __init__(self):
        self.images = {}

    def add_images(self, tag, grid, global_step=None):
        self.images[(tag, global_step)] = np.asarray(grid)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_image_grid_equals_jax(precision):
    """``write_images`` / ``_write_images_helper`` in both packages on the
    same weights, batch and prior noise: one NCHW grid of 16 real, 16
    deterministic reconstructions and 16 prior samples at ``cur_iter``; a
    uint8 batch gives the float batch's grid."""
    from intro_tc_vae_tpu.models import Decoder as JDecoder
    from intro_tc_vae_tpu.models import Encoder as JEncoder
    from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
    from intro_tc_vae_tpu.solvers import make_solver as jmake_solver
    from intro_tc_vae_tpu.solvers.base import decode as jdecode
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.models import conv_output_size
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver
    from intro_tc_vae_tpu_torch.utils import flax_to_port

    kw = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
    ds = datasets.Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    jds = jdatasets.Synthetic(image_size=32, cdim=3, sizes=(2, 2, 4, 4))
    bf16 = precision == "bf16"
    jkw = dict(kw, dtype=jnp.bfloat16) if bf16 else kw
    capture, jcapture = _Capture(), _Capture()
    jsolver = jmake_solver("intro_tc", dataset=jds, encoder=JEncoder(**jkw),
                           decoder=JDecoder(**jkw), batch_size=20,
                           optimizer_e=jmake_optimizer("adam", 1e-3),
                           optimizer_d=jmake_optimizer("adam", 1e-3),
                           writer=jcapture, test_iter=5)
    state = jsolver.init_state(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape),
                                                         a.dtype), state.batch_stats)
    state = state.replace(batch_stats=stats)
    batch = (rng.rand(20, 32, 32, 3) * 255).astype(np.uint8).astype(np.float32) / 255
    noise = rng.randn(20, 8).astype(np.float32)
    fake, _ = jdecode(jsolver.decoder, state.params["decoder"], state.batch_stats["decoder"],
                      jnp.asarray(noise), train=False)
    jsolver.write_images(state, jnp.asarray(batch), fake, cur_iter=10)
    jsolver.write_images(state, jnp.asarray(batch), fake, cur_iter=11)  # not a test_iter
    want = jcapture.images[("reconstructions", 10)]
    assert list(jcapture.images) == [("reconstructions", 10)] and want.shape == (48, 3, 32, 32)

    dt = torch.bfloat16 if bf16 else torch.float32
    enc, dec = Encoder(**kw, compute_dtype=dt), Decoder(**kw, compute_dtype=dt)
    SoftIntroVAE(enc, dec).load_state_dict(
        flax_to_port(state.params, stats, "conv", conv_output_size(32, (16, 32))))
    solver = make_solver("intro_tc", dataset=ds, encoder=enc, decoder=dec, batch_size=20,
                         optimizer_e=make_optimizer("adam", 1e-3),
                         optimizer_d=make_optimizer("adam", 1e-3),
                         writer=capture, test_iter=5)
    pstate = solver.init_state(0)
    x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
    solver._write_images_helper(pstate, x, 10, noise=torch.from_numpy(noise))
    solver._write_images_helper(pstate, x, 12, noise=torch.from_numpy(noise))
    got = capture.images[("reconstructions", 10)]
    assert list(capture.images) == [("reconstructions", 10)] and got.dtype == np.float32
    assert enc.training and dec.training  # eval passes give the mode back

    np.testing.assert_array_equal(got[:16], want[:16])  # the real images
    if bf16:
        layers_d = rounded_layers(dec)
        assert_close_bf16(got[16:32], want[16:32], rounded_layers(enc) + layers_d, "rec")
        assert_close_bf16(got[32:], want[32:], layers_d, "fake")
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    u8 = torch.from_numpy((batch * 255).round().astype(np.uint8).transpose(0, 3, 1, 2).copy())
    solver._write_images_helper(pstate, u8, 15, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(capture.images[("reconstructions", 15)], got)


# ---------------------------------------------------------------------------
# a host without scikit-learn
# ---------------------------------------------------------------------------

NO_SKLEARN = """
import importlib.abc, importlib.machinery, sys

# sklearn fails to import as where it is not installed; the spec has no
# origin, so torch's look-ups of third-party paths pass over it
class NoSklearn(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "sklearn":
            return importlib.machinery.ModuleSpec(name, self)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        raise ModuleNotFoundError(f"No module named {module.__name__!r}",
                                  name=module.__name__)

sys.meta_path.insert(0, NoSklearn())
for n in [n for n in sys.modules if n.split(".")[0] == "sklearn"]:
    del sys.modules[n]

import torch
torch.set_num_threads(1)
from intro_tc_vae_tpu_torch import evaluation, evaluate, train
from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.utils import tb_reader

root, log_dir, saves = sys.argv[1:4]
real = train.load_dataset

def load(name, data_root=None):
    ds, _, _, cdim = real("dsprites_small", data_root=root)
    ds.resize = 8
    ds.__class__ = type("Head", (type(ds),), {"__len__": lambda self: 320})
    return ds, 8, [8, 16], cdim

train.load_dataset = load
config = load_config("configs/tc_dsprites.json", dict(
    dataset="dsprites_small", num_epochs=1, batch_size=16, z_dim=8, test_iter=10,
    device_cache="off", log_dir=log_dir, checkpoint_dir=saves))
state = train.train_soft_intro_vae(config, device=torch.device("cpu"))
print("steps", state.step, "sklearn imported:", "sklearn" in sys.modules)
"""


def test_scores_without_sklearn(dsprites_root, tmp_path):
    """sklearn unimportable: the port imports and trains with the writer
    on; MIG and modularity are written at both test_iter steps; beta-VAE,
    DCI and explicitness print a ModuleNotFoundError for sklearn."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log_dir = tmp_path / "runs" / "tb"
    out = subprocess.run([sys.executable, "-c", NO_SKLEARN, dsprites_root, str(log_dir),
                          str(tmp_path / "saves")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "steps 20 sklearn imported: False" in lines
    for write in ("write_bvae_score", "write_dci_score", "write_mod_expl_score"):
        failed = [line for line in lines
                  if line.startswith(f"disentanglement metric {write} failed:")]
        assert len(failed) == 2 and all("ModuleNotFoundError" in f and "sklearn" in f
                                        for f in failed), (write, lines)
    assert not any("write_mig_score failed" in line for line in lines)
    run, = (tmp_path / "runs").iterdir()
    reader = TensorboardReader(str(run.parent), run.name)
    assert list(reader.mig_score["step"]) == [0, 10]
    assert list(reader.modularity_score["step"]) == [0, 10]
    assert not (run / "mod_expl_explicitness_score").exists()
    assert not any(p.name.startswith(("bvae_score", "dci")) for p in run.iterdir())
