"""The 128 px recipe's FID and disentanglement scores after a short training.

Counterpart of ``analysis/eval_config5.py`` (the JAX package's), with its
arguments and JSON keys: trains ``configs/intro_tc_128_dp8.json``'s recipe
(intro_tc, conv, z 128, Adam at the config's lr, its betas; bf16 convs on
the card) in one process for ``--steps`` steps of ``--batch`` images drawn
with replacement (RandomState(0)), the step graphed on the card
(``solvers/graph.py``), then reports:

* ``fid_inception_pool3``: FID between ``--num-samples`` real images and
  as many prior samples with InceptionV3-pool3 features, where a local
  weights file exists (``ITCVAE_INCEPTION_WEIGHTS``; nothing is
  downloaded), else the reason it is unavailable;
* ``fid_encoder_features``: the same FID in the model's own encoder-mean
  features;
* the four disentanglement score families (beta-VAE, DCI, MIG,
  modularity and explicitness), where the dataset has factors; a family
  that cannot import sklearn is recorded as ``<name>_error``, under the
  key the port's ``evaluate.py`` uses, and any other failure propagates,
  as in the JAX script.

The ARC Ukiyo-E corpus is absent here, so the default dataset is
``synthetic128`` (the same 128 px shapes, with factors).

    python -m intro_tc_vae_tpu_torch.analysis.eval_config5 --steps 300 [--dataset synthetic128]

Runs on the card unless ``--device cpu`` (float32 there). The TC and conv
kernels carry the step on the card (``tc_impl`` and ``conv_impl``
``pallas``; on the CPU their wrappers take the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "intro_tc_128_dp8.json")
SCORE_KEYS = {
    "bvae": ("bvae_score", "bvae_score_scaled"),
    "dci": ("dci_informativeness", "dci_completeness", "dci_disentanglement"),
    "mig": ("mig_score",),
    "mod_expl": ("modularity", "explicitness"),
}


def build(dataset_name: str, data_root, batch: int, device, scan_steps: int = 1):
    """(solver, state, dataset, cfg): the config's recipe over a fresh
    model on ``device``, graphed there when it is a card, with the TC and
    conv kernels (their plain versions on the CPU)."""
    import torch

    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    with open(CONFIG) as f:
        cfg = json.load(f)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.manual_seed(0)
    dataset, image_size, channels, cdim = load_dataset(dataset_name, data_root=data_root)
    dtype = torch.bfloat16 if cfg.get("precision") == "bf16" and cuda else torch.float32
    kwargs = dict(arch=cfg["arch"], cdim=cdim, zdim=cfg["z_dim"], channels=tuple(channels),
                  image_size=image_size, conv_impl="pallas", compute_dtype=dtype)
    solver = make_solver(
        cfg["solver"],
        dataset=dataset,
        encoder=Encoder(**kwargs).to(device),
        decoder=Decoder(**kwargs).to(device),
        batch_size=batch,
        optimizer_e=make_optimizer("adam", cfg["lr"]),
        optimizer_d=make_optimizer("adam", cfg["lr"]),
        beta_kl=cfg["beta_kl"], beta_rec=cfg["beta_rec"],
        beta_neg=cfg["beta_neg"], gamma_r=cfg["gamma_r"],
        tc_impl="pallas", scan_steps=scan_steps, graph=cuda,
    )
    state = solver.init_state(0)
    state.model.train()
    return solver, state, dataset, cfg


def train_call(solver, state, dataset, rng, batch: int, device):
    """One ``train_step`` call: ``solver.scan_steps`` batches of ``batch``
    images drawn with replacement from ``rng`` ([K, B, ...] for K > 1).
    Returns the call's metrics (0-d, or [K] tensors)."""
    import torch

    n, k = len(dataset), solver.scan_steps
    imgs = [dataset.get_batch(rng.randint(n, size=batch)).transpose(0, 3, 1, 2)
            for _ in range(k)]
    x = torch.from_numpy(np.ascontiguousarray(np.stack(imgs) if k > 1 else imgs[0]))
    _, metrics = solver.train_step(state, x.to(device))
    return metrics


def drain_finite(solver, keep_tail: int = 0) -> list:
    """The metric ring's entries but the newest ``keep_tail``, every inner
    step's metrics on the host; raises where any value of any step is not
    finite."""
    import math

    drained = solver.drain_metrics(keep_tail=keep_tail)
    for metrics, step in drained:
        bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
        if bad:
            raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
    return drained


def sample_prior(state, num: int, batch: int, zdim: int, seed: int) -> np.ndarray:
    """``num`` prior samples [num, H, W, C] decoded in eval mode by the
    current decoder, the noise drawn in batches from a generator seeded
    with ``seed`` on the model's device."""
    import torch

    from intro_tc_vae_tpu_torch.solvers.base import decode

    decoder = state.model.decoder
    device = next(decoder.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(0, num, batch):
        noise = torch.randn((batch, zdim), generator=gen, device=device)
        out.append(decode(decoder, noise, train=False).permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(out)[:num]


def scores(solver, state, num_samples: int, batch: int) -> dict:
    """The four families, rounded to 4 places under the JAX script's keys;
    a family that cannot import what it needs (sklearn) is recorded as
    ``<name>_error``. Any other failure, a device's or a kernel's among
    them, propagates."""
    from intro_tc_vae_tpu_torch.evaluation import metrics as em

    kw = dict(latent_generator=solver.latent_generator,
              encode_fn=solver.make_eval_encoder(state),
              num_samples=num_samples, batch_size=batch)
    families = {"bvae": em.compute_bvae_score, "dci": em.compute_dci_score,
                "mig": lambda **k: (em.compute_mig_score(**k),),
                "mod_expl": em.compute_mod_expl_score}
    out = {}
    for name, fn in families.items():
        try:
            out.update({k: round(float(v), 4) for k, v in zip(SCORE_KEYS[name], fn(**kw))})
        except ImportError as e:  # a missing package must not lose the other families
            out[f"{name}_error"] = repr(e)
    return out


FID_UNAVAILABLE = ("unavailable offline (no pretrained weights; set "
                   "ITCVAE_INCEPTION_WEIGHTS)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dataset", default="synthetic128")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-samples", type=int, default=640,
                    help="images per side for FID / metric sample count")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "eval_config5_torch.json"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    from intro_tc_vae_tpu_torch.evaluation.fid import encoder_fid, standard_fid
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH
    from intro_tc_vae_tpu_torch.train import true_fp32

    device = torch.device(a.device)
    solver, state, dataset, cfg = build(a.dataset, a.data_root, a.batch, device)
    rng = np.random.RandomState(0)
    n = len(dataset)
    last = None
    for i in range(a.steps):
        train_call(solver, state, dataset, rng, a.batch, device)
        if len(solver.metric_ring) >= RING_DEPTH + 2:
            drained = drain_finite(solver, keep_tail=2)
            last = drained[-1][0]
        if (i + 1) % 50 == 0 and last is not None:
            print(f"step {i + 1}/{a.steps} lossE={last['loss_enc']:.4f} "
                  f"lossD={last['loss_dec']:.4f} rec={last['loss_rec']:.1f}")
    drained = drain_finite(solver)
    if drained:
        last = drained[-1][0]

    results = {"config": "intro_tc_128_dp8 (BASELINE config 5)",
               "dataset": a.dataset, "steps": a.steps,
               "final_loss_rec": round(float(last["loss_rec"]), 2) if last else None}
    with true_fp32("fp32"):
        real = dataset.get_batch(rng.randint(n, size=a.num_samples))
        fake = sample_prior(state, a.num_samples, a.batch, cfg["z_dim"], seed=7)
        fid_std = standard_fid(real, fake, batch_size=a.batch, device=device)
        results["fid_inception_pool3"] = (round(fid_std, 3) if fid_std is not None
                                          else FID_UNAVAILABLE)
        results["fid_encoder_features"] = round(
            encoder_fid(solver, state, real, fake, batch_size=a.batch), 3)
        if solver.latent_generator is not None:
            results.update(scores(solver, state, min(a.num_samples, n // 2), a.batch))

    print(json.dumps(results, indent=2))
    with open(a.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
