"""Harnesses of the port, each run as ``python -m
intro_tc_vae_tpu_torch.analysis.<name>``: ``profile_step`` (where a train
step's device and host time go), ``bench_system`` (the real train loop's
throughput by data path, eager and graphed) and ``bench_loader`` (the
host's batch rate). Counterparts of the JAX package's ``analysis/``
scripts; they import no jax and nothing of ``intro_tc_vae_tpu``."""
