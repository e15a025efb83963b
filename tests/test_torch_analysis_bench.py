"""PyTorch port: the harnesses ``bench_conv_kernel``, ``ceiling``,
``doctor_rehearsal`` and ``scaling_comms`` (``intro_tc_vae_tpu_torch/
analysis/``) on the CPU, held to the JAX package's scripts where the CPU
can run both.

* ``bench_conv_kernel`` with ``--device cpu``: the equality check (the
  plain conv against ``F.conv2d`` within the JAX script's relative 3e-2),
  the five arms timed, no launch anywhere; the launches it expects of each
  arm on the card.
* ``ceiling``'s count of one step at a tiny size equals a closed form of
  its conv and linear products: each layer call's forward products, once
  more for the input gradient where the input requires one and once more
  for the weight gradient where the weight does, summed over the step's
  passes (forward hooks); the TC op's operations per call, 5 calls of the
  intro step and 1 of the tc step, each differentiated.
* ``doctor_rehearsal``'s exit codes and the (status, check) pair of every
  report line equal ``analysis/doctor_rehearsal.py``'s (the JAX doctor, in
  a subprocess whose copy of the script writes into a temporary tree).
* ``scaling_comms``' tally over 2 gloo ranks equals the closed forms of
  the gradient average, the metric average and the TC's bank gather, in
  each of its three phases.
* Every new harness module imports with jax, the JAX package,
  matplotlib, sklearn and umap made unimportable (a subprocess), and
  ``model_vis`` then names every projection and figure it did not draw.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch.analysis import bench_conv_kernel as bck
from intro_tc_vae_tpu_torch.analysis import ceiling, doctor_rehearsal, scaling_comms
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("_timing", "bench_conv_kernel", "ceiling", "doctor_rehearsal",
               "stability_report", "run_vis", "model_vis", "eval_config5",
               "eval_config5_trend", "scaling_comms")


# ---------------------------------------------------------------------------
# bench_conv_kernel
# ---------------------------------------------------------------------------

def test_bench_conv_kernel_equality_check_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bck, "REPS", 2)
    out = bck.main(["--device", "cpu", "--batch", "2", "--size", "16"])
    assert out["equal"] and out["launches_ok"] and out["card"] is None
    assert set(out["check"]) == {"fwd", "dx", "dw"}
    assert all(e["rel"] < bck.REL_TOL and e["ref_max"] > 0 for e in out["check"].values())
    assert list(out["arms"]) == ["fwd xla", "fwd pallas", "fwd+bwd xla", "fwd+bwd pallas",
                                 "fwd+bwd hybrid"]
    gflop = 2 * 2 * 16 * 16 * 64 * 64 * 9 / 1e9
    for name, arm in out["arms"].items():
        assert arm["us"] > 0 and arm["launches"] == {}
        assert arm["gflop"] == pytest.approx(3 * gflop if "bwd" in name else gflop)


@pytest.mark.parametrize("shape,dtype,body", [
    ((64, 64, 64, 64), torch.bfloat16, "wgmma"),
    ((8, 64, 48, 48), torch.bfloat16, "ragged"),
    ((64, 64, 64, 64), torch.float32, None),
], ids=["wgmma", "ragged", "fp32"])
def test_bench_conv_kernel_expected_launches(shape, dtype, body):
    fwd = f"conv3x3_fwd_{body}" if body else "conv3x3_fwd"
    dw = f"conv3x3_dw_{body}" if body else "conv3x3_dw"
    want = {"fwd xla": {}, "fwd+bwd xla": {},
            "fwd pallas": {fwd: 1, "conv3x3_pack_w": 1},
            "fwd+bwd pallas": {fwd: 2, "conv3x3_pack_w": 2, dw: 1, "conv3x3_dw_reduce": 1},
            "fwd+bwd hybrid": {fwd: 1, "conv3x3_pack_w": 1, dw: 1, "conv3x3_dw_reduce": 1}}
    for name, launches in want.items():
        assert bck.expected_launches(name, shape, dtype, cuda=True) == launches, name
        assert bck.expected_launches(name, shape, dtype, cuda=False) == {}


# ---------------------------------------------------------------------------
# ceiling
# ---------------------------------------------------------------------------

TINY = dict(image_size=16, batch=4, channels=(8, 16), zdim=8)


@pytest.mark.parametrize("solver_name,tc_calls", [("intro_tc", 5), ("vae", 0), ("tc", 1)])
def test_ceiling_count_equals_the_closed_form(solver_name, tc_calls):
    count = ceiling.step_flops(solver_name, TINY["image_size"], TINY["batch"], "cpu",
                               TINY["channels"], TINY["zdim"])
    solver, state, x = ceiling.build(solver_name, TINY["image_size"], TINY["batch"], "cpu",
                                     TINY["channels"], TINY["zdim"])
    assert count["products"] == ceiling.products_from_shapes(solver, state, x)
    assert count["tc_calls"] == tc_calls
    b, z = TINY["batch"], TINY["zdim"]
    per_call = b * b * (z * (37 + 44 + 41) + 33 + 32 + 32)  # tc_fwd, tc_bwd_dz, tc_bwd_dmu
    assert ceiling.tc_call_ops(b, z, True) == per_call
    assert count["tc"] == tc_calls * per_call
    assert count["total"] == count["products"] + count["tc"]


def test_ceiling_count_beside_jax_cost_analysis(capsys):
    """The flagship solver's count at 32 px (channels 16-32, z 128, batch
    8) beside XLA's ``cost_analysis()`` flops of the JAX step, built as
    analysis/ceiling.py builds it. The ratio is printed, not held: XLA
    counts the elementwise work the port's count leaves out and drops
    the dead products autograd computes."""
    import jax
    import jax.numpy as jnp

    from intro_tc_vae_tpu.data import Synthetic as JSynthetic
    from intro_tc_vae_tpu.models import Decoder as JDecoder
    from intro_tc_vae_tpu.models import Encoder as JEncoder
    from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
    from intro_tc_vae_tpu.solvers import make_solver as jmake_solver

    s, channels, b, z = 32, (16, 32), 8, 128
    kw = dict(cdim=3, zdim=z, channels=channels, image_size=s, dtype=None)
    solver = jmake_solver("intro_tc", dataset=JSynthetic(image_size=s, cdim=3, sizes=(4, 5, 8, 8)),
                          encoder=JEncoder(arch="conv", **kw), decoder=JDecoder(arch="conv", **kw),
                          batch_size=b, optimizer_e=jmake_optimizer("adam", 2e-4),
                          optimizer_d=jmake_optimizer("adam", 2e-4), beta_kl=0.5,
                          beta_rec=0.75, beta_neg=512.0)
    x = jnp.zeros((b, s, s, 3), jnp.float32)
    cost = solver._step_fn.lower(solver.init_state(jax.random.key(0), x), x).compile()
    cost = cost.cost_analysis()
    jax_flops = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    ours = ceiling.step_flops("intro_tc", s, b, "cpu", channels, z)["total"]
    assert jax_flops > 0 and ours > 0
    with capsys.disabled():
        print(f"\nceiling, intro_tc at {s} px, channels {channels}, z {z}, batch {b}: port "
              f"{ours:,} operations, XLA cost_analysis {jax_flops:,.0f} flops, ratio "
              f"{ours / jax_flops:.4f}")


def test_ceiling_command_rows(monkeypatch):
    monkeypatch.setitem(ceiling.CHANNELS, 16, (8, 16))
    monkeypatch.setattr(ceiling, "Z_DIM", 8)
    monkeypatch.setattr(ceiling, "MATMUL_SIZE", 64)
    monkeypatch.setattr(ceiling, "MATMUL_CHAIN", 2)
    out = ceiling.main(["--device", "cpu", "--only", "vae:16:4"])
    row, = out["rows"]
    assert out["sustained_tflops"] > 0 and out["nominal_tflops"] == 989.0
    assert row["gflop_per_image"] == round(row["step_flops"]["total"] / 4 / 1e9, 3)
    assert row["ceiling_img_s"] == pytest.approx(
        out["sustained_tflops"] * 1e3 / (row["step_flops"]["total"] / 4 / 1e9), rel=1e-3)
    assert [c[:3] for c in ceiling.CONFIGS] == [
        ("intro_tc", 64, 64), ("intro_tc", 128, 64), ("intro_tc", 256, 32),
        ("intro_tc", 256, 64), ("vae", 64, 64), ("tc", 64, 64)]


# ---------------------------------------------------------------------------
# doctor_rehearsal against the JAX script
# ---------------------------------------------------------------------------

JAX_REHEARSAL = """
import sys
sys.path.insert(0, {repo!r})
import analysis.doctor_rehearsal as rehearsal
rehearsal._REPO = {root!r}  # its transcript goes to this tree's docs/
rehearsal.main()
"""


def _jax_cases(tmp_path) -> list:
    """(exit code, [(status, check)]) of each case of the JAX script."""
    root = tmp_path / "jax_tree"
    (root / "docs").mkdir(parents=True)
    (root / "tests").mkdir()
    os.symlink(os.path.join(REPO, "tests", "test_data"), root / "tests" / "test_data")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("ITCVAE_INCEPTION_WEIGHTS", None)
    out = subprocess.run([sys.executable, "-c", JAX_REHEARSAL.format(repo=REPO, root=str(root))],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    cases, lines = [], []
    for line in out.stdout.splitlines():
        m = doctor_rehearsal.LINE.match(line)
        if m:
            lines.append(list(m.groups()))
        elif line.startswith("[exit code "):
            cases.append((int(line.split()[2].rstrip("]")), lines))
            lines = []
    return cases


def test_doctor_rehearsal_matches_the_jax_script(tmp_path, monkeypatch):
    monkeypatch.delenv("ITCVAE_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)  # the doctor probes ./saves, as the JAX script's does
    out_path = tmp_path / "rehearsal.txt"
    ours = doctor_rehearsal.main(["--device", "cpu", "--out", str(out_path)])
    theirs = _jax_cases(tmp_path)
    assert [c["exit"] for c in ours["cases"]] == [0, 0, 0, 1, 1, 1]
    assert [(c["exit"], c["lines"]) for c in ours["cases"]] == theirs
    text = out_path.read_text()
    assert text.count("[exit code ") == 6 and str(tmp_path) not in text


# ---------------------------------------------------------------------------
# scaling_comms over 2 gloo ranks
# ---------------------------------------------------------------------------

def test_scaling_comms_tally_equals_the_closed_form():
    ranks = scaling_comms.run_ranks(2, tiny=True, device="cpu", timeout=240)
    assert len(ranks) == 2
    for r in ranks:
        assert scaling_comms.mismatches(r) == []
        assert r["meta"]["n_ranks"] == 2 and r["meta"]["batch"] == 4
    dp, tc, tp = (ranks[0][p] for p in ("dp", "dp_gathered_tc", "tp2_dp"))
    whole = dp["param_bytes"]
    assert dp["by_site"]["average_grads"] == {"kind": "all-reduce", "count": 2, "bytes": whole}
    assert dp["expected"]["all_gather_rows"] == 5 * 4 * 4 * 16
    assert dp["all-gather"]["count"] == dp["reduce-scatter"]["count"] == 5
    assert {k: v for k, v in tc.items() if k not in ("by_site",)} == {
        k: v for k, v in dp.items() if k not in ("by_site",)}
    # TP2 x DP1: the model axis gathers channels; only replicated gradients average
    assert tp["all-gather"]["count"] > 0 and "all_gather_rows" not in tp["by_site"]
    assert 0 < tp["by_site"]["average_grads"]["bytes"] < tp["param_bytes_rank"] < whole
    assert all(r[p]["expected"] == ranks[0][p]["expected"]
               for r in ranks[1:] for p in ("dp", "tp2_dp"))


# ---------------------------------------------------------------------------
# no jax, no figures: a subprocess
# ---------------------------------------------------------------------------

NO_JAX = """
import importlib.abc, importlib.machinery, json, sys

BLOCKED = ("jax", "jaxlib", "intro_tc_vae_tpu", "matplotlib", "sklearn", "umap")

class Blocked(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # a spec whose loading fails, as where the package is absent (torch looks
    # up third-party names at import and breaks on a finder that raises)
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        raise ModuleNotFoundError(f"No module named {module.__name__!r}",
                                  name=module.__name__)

sys.meta_path.insert(0, Blocked())
import importlib
import torch
torch.set_num_threads(1)
for name in sys.argv[1].split(","):
    importlib.import_module("intro_tc_vae_tpu_torch.analysis." + name)
from intro_tc_vae_tpu_torch.analysis import model_vis
out = model_vis.main(["--device", "cpu", "--dataset", "synthetic_small", "--arch", "conv",
                      "--z-dim", "4", "--out", sys.argv[2]])
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m])
print(json.dumps({"bad": bad, **out}))
"""


def test_new_harnesses_import_no_jax_and_name_what_they_did_not_draw(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", NO_JAX, ",".join(NEW_MODULES),
                          str(tmp_path / "mv")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["bad"] == [] and r["drawn"] == [] and r["encoded"] == 64
    assert r["not_drawn"] == ["interpolations.png", "latents_lda.png", "latents_pca.png",
                              "latents_tsne.png", "latents_umap.png", "traversals.png"]
    assert all("sklearn" in why for why in r["projections"].values())
    assert os.listdir(tmp_path / "mv") == []
    assert not np.isnan(r["encoded"])
