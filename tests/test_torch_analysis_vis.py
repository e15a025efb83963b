"""PyTorch port: the harnesses ``stability_report``, ``run_vis`` and
``model_vis`` (``intro_tc_vae_tpu_torch/analysis/``) against the JAX
package's scripts (``analysis/``) on the CPU.

* Two TensorBoard runs written with tensorboardX (the layout both
  readers read: the loss scalars, the ``losses`` family, MIG in one run
  only, a reconstruction image per run) from a seeded RNG.
* ``stability_report``: the JSON summary of one run equals the JAX
  script's (every curve's steps, finiteness, first, final, min, max); a
  run with a NaN makes both exit with 1.
* ``run_vis``: the same figures written as the JAX script's, and each
  run's curves (steps, final value) as the JAX reader reads them.
* ``model_vis`` on the JAX harness's model, its weights carried over with
  ``flax_to_port`` (BatchNorm statistics randomized, so that eval mode
  normalizes with something other than 0 / 1): ``encode_dataset``'s
  means and labels, the traversal decodes and the interpolation decodes
  equal the JAX functions' (the images they hand ``imshow``), float32,
  atol 1e-5.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.analysis import model_vis, run_vis, stability_report
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

RUN = "intro_tc_synthetic_betas_0.5_512.0_0.75_1e-08_zdim_8_conv_{}"
STEPS = 30


def _write_run(root, name: str, seed: int, nan_at=None, mig: bool = True) -> None:
    from tensorboardX import SummaryWriter

    rng = np.random.RandomState(seed)
    writer = SummaryWriter(log_dir=os.path.join(root, name))
    for step in range(STEPS):
        v = rng.uniform(0.1, 100.0, size=8)
        if nan_at == step:
            v[1] = np.nan
        for tag, x in zip(("lossE", "lossD", "r_loss_unscaled", "kl_loss_unscaled", "diff_kl"),
                          v):
            writer.add_scalar(tag, float(x), step)
        writer.add_scalars("losses", {"r_loss": float(v[5]), "kl_loss": float(v[6]),
                                      "expelbo_f": float(v[7])}, step)
        if mig and step % 10 == 0:
            writer.add_scalar("mig_score", float(v[0] / 100), step)
        if step in (10, 20):
            img = (rng.uniform(0, 1, (3, 8, 16)) * 255).astype(np.uint8)
            writer.add_image("reconstructions", img, step)
    writer.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    _write_run(str(root), RUN.format("a"), 0)
    _write_run(str(root), RUN.format("b"), 1, mig=False)
    return str(root)


def _jax_main(module, argv: list):
    """A JAX script's ``main`` with ``argv``; its exit code (0 when it
    returns)."""
    saved = sys.argv
    sys.argv = [module.__file__, *argv]
    try:
        module.main()
    except SystemExit as e:
        return e.code
    finally:
        sys.argv = saved
    return 0


def test_stability_report_matches_the_jax_script(runs, tmp_path):
    from analysis import stability_report as jax_report

    ours = stability_report.main(["--run-dir", runs, "--run-pattern", "_a$",
                                  "--out", str(tmp_path / "ours")])
    assert _jax_main(jax_report, ["--run-dir", runs, "--run-pattern", "_a$",
                                  "--out", str(tmp_path / "jax")]) == 0
    mine = json.loads((tmp_path / "ours.json").read_text())
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert mine == theirs and mine["run"] == RUN.format("a") == ours["run"]
    assert set(mine["curves"]) == {"lossE", "lossD", "rec (unscaled)", "kl (unscaled)",
                                   "expelbo_f", "diff_kl"}
    assert all(c["steps"] == STEPS and c["finite"] for c in mine["curves"].values())
    assert (tmp_path / "ours.png").exists() and ours["figure"] == str(tmp_path / "ours.png")


def test_stability_report_exits_1_on_a_non_finite_curve(tmp_path):
    from analysis import stability_report as jax_report

    root = str(tmp_path / "runs")
    _write_run(root, RUN.format("nan"), 2, nan_at=17)
    with pytest.raises(SystemExit) as e:
        stability_report.main(["--run-dir", root, "--out", str(tmp_path / "ours")])
    assert e.value.code == 1
    assert _jax_main(jax_report, ["--run-dir", root, "--out", str(tmp_path / "jax")]) == 1
    mine = json.loads((tmp_path / "ours.json").read_text())
    assert mine == json.loads((tmp_path / "jax.json").read_text())
    assert [k for k, c in mine["curves"].items() if not c["finite"]] == ["lossD"]


def test_run_vis_matches_the_jax_script(runs, tmp_path):
    from analysis import run_vis as jax_vis

    ours = run_vis.main(["--run-dir", runs, "--out", str(tmp_path / "ours")])
    assert _jax_main(jax_vis, ["--run-dir", runs, "--out", str(tmp_path / "jax")]) == 0
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(ours["figures"]) == len(run_vis.CURVES) and not ours["not_drawn"]
    assert len(ours["reconstructions"]) == 2
    assert run_vis.CURVES == jax_vis.CURVES
    readers = {r: jax_vis.TensorboardReader(runs, r) for r in ours["runs"]}
    want = {}
    for name, reader in readers.items():
        want[name] = {}
        for attr, _ in jax_vis.CURVES:
            try:
                df = getattr(reader, attr)
            except Exception:
                continue
            want[name][attr] = {"steps": len(df), "final": float(df["value"].iloc[-1])}
    assert ours["runs"] == want
    assert "mig_score" in ours["runs"][RUN.format("a")]
    assert "mig_score" not in ours["runs"][RUN.format("b")]


# ---------------------------------------------------------------------------
# model_vis on the same weights
# ---------------------------------------------------------------------------

ATOL = 1e-5  # float32 encodes and decodes of two packages on the same weights


@pytest.fixture(scope="module")
def models():
    """(JAX solver, state, dataset; port solver, state, dataset) with the
    same weights and randomized BatchNorm statistics."""
    import jax

    from analysis import model_vis as jax_model_vis
    from intro_tc_vae_tpu_torch.models.vae import conv_output_size
    from intro_tc_vae_tpu_torch.utils import flax_to_port

    jsolver, jstate, jds = jax_model_vis.build_model("conv", 8, "synthetic_small")
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32) if a.ndim else a,
        jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    solver, state, ds = model_vis.build_model("conv", 8, "synthetic_small", device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state.model.load_state_dict(flax_to_port(
        params, jax.tree_util.tree_map(np.asarray, stats), "conv",
        conv_output_size(solver.encoder.image_size, solver.encoder.channels)))
    return (jsolver, jstate, jds), (solver, state, ds)


def _imshown(monkeypatch):
    """The images handed to ``Axes.imshow``, in order."""
    import matplotlib.axes

    shown, imshow = [], matplotlib.axes.Axes.imshow

    def record(self, x, *args, **kwargs):
        shown.append(np.asarray(x))
        return imshow(self, x, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", record)
    return shown


def test_model_vis_encodes_and_decodes_match_the_jax_harness(models, monkeypatch, tmp_path):
    from analysis import model_vis as jax_model_vis

    (jsolver, jstate, jds), (solver, state, ds) = models
    jz, jlabels = jax_model_vis.encode_dataset(jsolver, jstate, jds)
    z, labels = model_vis.encode_dataset(solver, state, ds)
    assert z.shape == jz.shape == (len(ds), 8) and z.dtype == np.float32
    np.testing.assert_allclose(z, jz, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(labels, jlabels)
    assert np.std(z, axis=0).min() > 0

    shown = _imshown(monkeypatch)
    jax_model_vis.plot_traversals(jsolver, jstate, jz[0], str(tmp_path))
    rows = model_vis.traversals(state, jz[0])
    assert len(rows) == 8 and rows[0].shape[0] == 11
    ours = [np.squeeze(img) for row in rows for img in row]
    assert len(shown) == len(ours) == 88
    for a, b in zip(ours, shown):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)

    shown.clear()
    jax_model_vis.plot_interpolations(jsolver, jstate, jds, str(tmp_path))
    ours = [np.squeeze(img) for row in model_vis.interpolations(solver, state, ds)
            for img in row]
    assert len(shown) == len(ours) == 32
    for a, b in zip(ours, shown):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_model_vis_command_draws_every_figure(tmp_path):
    out = model_vis.main(["--device", "cpu", "--dataset", "synthetic_small", "--arch", "conv",
                          "--z-dim", "4", "--out", str(tmp_path)])
    assert out["encoded"] == 64
    assert {"traversals.png", "interpolations.png", "latents_pca.png",
            "latents_tsne.png"} <= set(out["drawn"]) <= set(os.listdir(tmp_path))
    assert out["projections"]["pca"] == "drawn"
    assert out["projections"]["umap"].startswith("skipped")
