"""PyTorch port: the harnesses ``eval_config5`` and ``eval_config5_trend``
(``intro_tc_vae_tpu_torch/analysis/``) on the CPU, with the JAX
scripts' keys (``analysis/eval_config5.py``, ``analysis/
eval_config5_trend.py``).

* ``eval_config5`` end to end at ``synthetic_small``: JAX's keys, every
  value finite, FID from Inception named unavailable without weights; a
  score family that raises is recorded as ``<name>_error`` and the others
  are kept.
* ``eval_config5_trend`` end to end at ``synthetic_small``, ``--steps 4
  --eval-points 2 --batch 8 --num-samples 96``: points at steps 0, 2 and
  4 with JAX's keys, finite, the figure written and no ``.partial.json``
  left.
* The JAX script's three faults, fixed in the port's copy: the scan width
  divides every spacing of the eval points (``scan_width``; the JAX
  formula's width steps over a point), and a NaN in an inner step of a
  scanned call fails the finite check although the call's last step is
  finite (``drain_finite``).
"""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.analysis import eval_config5, eval_config5_trend
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

SCORES = ("bvae_score", "bvae_score_scaled", "dci_informativeness", "dci_completeness",
          "dci_disentanglement", "mig_score", "modularity", "explicitness")
CONFIG5_KEYS = {"config", "dataset", "steps", "final_loss_rec", "fid_inception_pool3",
                "fid_encoder_features", *SCORES}
TREND_KEYS = {"config", "dataset", "steps", "num_samples", "fid_note", "points",
              "total_seconds"}


@pytest.fixture
def seeded_factors(monkeypatch):
    """The solvers' latent generators seeded (the harnesses leave them
    unseeded, as JAX's do), the seed advancing at every read as
    tests/test_torch_evaluation.py::_cycling advances it (quirk Q14: the
    beta-VAE batch re-seeds from it at every call). At these sizes (32
    samples in batches of 8) an unseeded beta-VAE draw holds a single
    factor in ~1.6 % of calls and sklearn then refuses it (recorded as
    ``bvae_error``); seeded, every run draws the same factors."""
    from intro_tc_vae_tpu_torch.evaluation import generator

    class Seeded(generator.LatentGenerator):
        def __init__(self, data_source, seed=None):
            super().__init__(data_source, seed=3 if seed is None else seed)

        @property
        def seed(self):
            self._reads += 1
            return self._seed + self._reads

        @seed.setter
        def seed(self, value):
            self._seed, self._reads = value, 0

    monkeypatch.setattr(generator, "LatentGenerator", Seeded)


def test_eval_config5_end_to_end(tmp_path, monkeypatch, seeded_factors):
    monkeypatch.delenv("ITCVAE_INCEPTION_WEIGHTS", raising=False)
    out = tmp_path / "config5.json"
    r = eval_config5.main(["--device", "cpu", "--dataset", "synthetic_small", "--steps", "3",
                           "--batch", "8", "--num-samples", "32", "--out", str(out)])
    assert set(r) == CONFIG5_KEYS and json.loads(out.read_text()) == r
    assert r["steps"] == 3 and r["config"] == "intro_tc_128_dp8 (BASELINE config 5)"
    assert r["fid_inception_pool3"].startswith("unavailable")
    assert all(math.isfinite(r[k]) for k in ("final_loss_rec", "fid_encoder_features",
                                              *SCORES))


def test_a_failing_score_family_is_recorded_as_its_error(monkeypatch):
    """One family raising (as where sklearn is absent) leaves its
    ``<name>_error`` and every other family's values under JAX's keys."""
    from intro_tc_vae_tpu_torch.evaluation import metrics as em

    def no_sklearn(**kwargs):
        raise ModuleNotFoundError("No module named 'sklearn'")

    monkeypatch.setattr(em, "compute_bvae_score", lambda **kw: (0.5, 0.25))
    monkeypatch.setattr(em, "compute_dci_score", no_sklearn)
    monkeypatch.setattr(em, "compute_mig_score", lambda **kw: 0.125)
    monkeypatch.setattr(em, "compute_mod_expl_score", lambda **kw: (0.75, 0.0625))
    solver = types.SimpleNamespace(latent_generator=object(),
                                   make_eval_encoder=lambda state: None)
    r = eval_config5.scores(solver, None, 16, 8)
    assert r == {"bvae_score": 0.5, "bvae_score_scaled": 0.25, "mig_score": 0.125,
                 "modularity": 0.75, "explicitness": 0.0625,
                 "dci_error": "ModuleNotFoundError(\"No module named 'sklearn'\")"}


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal memory access"),
                                   ValueError("a shape the encoder refuses")])
def test_a_score_family_failing_for_another_reason_raises(monkeypatch, error):
    """Only a missing package is recorded as ``<name>_error``: a device's,
    a kernel's or a shape's failure in a family propagates."""
    from intro_tc_vae_tpu_torch.evaluation import metrics as em

    def fails(**kwargs):
        raise error

    monkeypatch.setattr(em, "compute_bvae_score", lambda **kw: (0.5, 0.25))
    monkeypatch.setattr(em, "compute_dci_score", fails)
    solver = types.SimpleNamespace(latent_generator=object(),
                                   make_eval_encoder=lambda state: None)
    with pytest.raises(type(error), match=str(error)):
        eval_config5.scores(solver, None, 16, 8)


def test_eval_config5_trend_end_to_end(tmp_path, monkeypatch, seeded_factors):
    monkeypatch.delenv("ITCVAE_INCEPTION_WEIGHTS", raising=False)
    out = str(tmp_path / "trend")
    r = eval_config5_trend.main(["--device", "cpu", "--dataset", "synthetic_small",
                                 "--steps", "4", "--eval-points", "2", "--batch", "8",
                                 "--num-samples", "96", "--out", out])
    assert set(r) == TREND_KEYS and json.loads(open(out + ".json").read()) == r
    points = r["points"]
    assert [p["step"] for p in points] == [0, 2, 4]
    first = {"step", "eval_seconds", "fid_final_encoder", *SCORES}
    assert set(points[0]) == first
    for p in points[1:]:
        assert set(p) == first | {"loss_rec", "loss_enc"}
    for p in points:
        assert all(math.isfinite(v) for k, v in p.items() if k != "step")
    assert os.path.exists(out + ".png")
    assert not os.path.exists(out + ".partial.json")


@pytest.mark.parametrize("steps,points,scan,width", [
    (10, 3, 10, 1),       # eval at 0, 3, 7, 10: spacings 3 and 4
    (4, 2, 10, 2),        # 0, 2, 4
    (10000, 6, 10, 1),    # 0, 1667, 3333, 5000, ...: spacings 1667 and 1666
    (6000, 6, 10, 10),    # spacing 1000
    (12, 2, 4, 3),        # spacing 6: the largest divisor up to 4
    (5, 5, 10, 1),
])
def test_scan_width_divides_every_spacing(steps, points, scan, width):
    eval_at = eval_config5_trend.eval_steps(steps, points)
    k = eval_config5_trend.scan_width(scan, eval_at)
    assert k == width and k <= scan
    assert all((b - a) % k == 0 for a, b in zip(eval_at, eval_at[1:]))
    # the JAX script's width, min(scan, steps // points), steps past a point
    jax_k = max(1, min(scan, steps // max(1, points) or 1))
    if (steps, points) == (10, 3):
        assert jax_k == 3 and any((b - a) % jax_k for a, b in zip(eval_at, eval_at[1:]))


def test_a_nan_in_an_inner_scan_step_fails_the_finite_check():
    from intro_tc_vae_tpu_torch.solvers.base import MetricRing

    ring = MetricRing()
    ok = {"loss_enc": torch.tensor([0.5, 0.4, 0.3]), "loss_rec": torch.tensor([9.0, 8.0, 7.0])}
    ring.push(ok, 1)
    solver = types.SimpleNamespace(drain_metrics=lambda keep_tail=0: ring.drain(keep_tail))
    drained = eval_config5.drain_finite(solver)
    assert [s for _, s in drained] == [1, 2, 3]
    bad = {"loss_enc": torch.tensor([0.5, float("nan"), 0.3]),
           "loss_rec": torch.tensor([9.0, 8.0, 7.0])}
    ring.push(bad, 4)
    assert math.isfinite(float(bad["loss_enc"][-1]))  # the last step alone looks fine
    with pytest.raises(FloatingPointError, match="step 5"):
        eval_config5.drain_finite(solver)
    assert not np.isnan(drained[-1][0]["loss_enc"])


def test_the_trend_checks_the_kept_tail_before_an_eval_point(tmp_path, monkeypatch):
    """The trend drains as ``eval_config5`` does, the two newest calls
    left in the ring, and drains all of it before an eval point: a NaN in
    the last call before the point fails the run before its scores."""
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH, MetricRing

    steps = RING_DEPTH + 4
    ring = MetricRing()
    solver = types.SimpleNamespace(metric_ring=ring, scan_steps=1,
                                   drain_metrics=lambda keep_tail=0: ring.drain(keep_tail))

    class Data:
        def __len__(self):
            return 64

        def get_batch(self, idx):
            return np.zeros((len(idx), 1))

    queued, scored = [], []

    def train_call(solver_, state, data, rng, batch, device):
        value = float("nan") if len(queued) + 1 == steps else 0.5
        ring.push({"loss_enc": torch.tensor(value), "loss_rec": torch.tensor(1.0)},
                  len(queued) + 1)
        queued.append(len(ring))  # the ring's entries once the call is queued

    monkeypatch.setattr(eval_config5, "build",
                        lambda *a, **k: (solver, None, Data(), {"z_dim": 1}))
    monkeypatch.setattr(eval_config5, "train_call", train_call)
    monkeypatch.setattr(eval_config5, "sample_prior", lambda *a, **k: np.zeros((1, 1)))
    monkeypatch.setattr(eval_config5, "scores", lambda *a, **k: scored.append(len(queued)) or {})
    with pytest.raises(FloatingPointError, match=f"step {steps}"):
        eval_config5_trend.main(["--device", "cpu", "--steps", str(steps), "--eval-points", "1",
                                 "--scan", "1", "--out", str(tmp_path / "trend")])
    assert len(queued) == steps and scored == [0]
    assert max(queued) == RING_DEPTH + 2  # drained down to 2 there
    assert queued[-1] < RING_DEPTH + 2    # the NaN call stayed in the tail until the point
