"""Harnesses of the port, each run as ``python -m
intro_tc_vae_tpu_torch.analysis.<name>``: ``profile_step`` (where a train
step's device and host time go), ``bench_system`` (the real train loop's
throughput by data path, eager and graphed), ``bench_loader`` (the host's
batch rate), ``bench_conv_kernel`` (the routed conv's kernels against
cuDNN), ``ceiling`` (operations of a step and the card's speed of light),
``doctor_rehearsal`` (the preflight's transcripts), ``stability_report``
and ``run_vis`` (TensorBoard runs), ``model_vis`` (a checkpoint's latents
and decodes), ``eval_config5`` and ``eval_config5_trend`` (the 128 px
recipe's FID and scores, once and over training) and ``scaling_comms``
(what a parallel step's collectives move). ``_timing`` is their shared
timer. Counterparts of the JAX package's ``analysis/`` scripts; they
import no jax and nothing of ``intro_tc_vae_tpu``."""
