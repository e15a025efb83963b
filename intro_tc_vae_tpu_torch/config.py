"""Run configuration: dataclass defaults <- JSON file <- inline update dict.

A copy of ``intro_tc_vae_tpu/config.py`` (same fields, defaults, merge
order and validation), so every ``configs/*.json`` loads unchanged. The
port cannot import the JAX package: importing it imports jax. Which of
these options the port carries yet is checked in ``train.py``
(``check_ported``); the rest raise ``NotImplementedError`` there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # --- reference fields (config.py:7-36) ---
    solver: str = None
    dataset: str = None
    arch: str = "res"
    optimizer: str = "adam"
    recon_loss_type: str = "mse"
    device: int = -1            # kept for config compat; the port uses cuda:0

    lr: float = 2e-4
    batch_size: int = 128
    num_epochs: int = 200
    seed: int = -1

    z_dim: int = 32
    beta_rec: float = 1.0
    beta_kl: float = 1.0
    beta_neg: float = 1.0
    gamma_r: float = 1e-8

    use_tensorboard: bool = False
    use_amp: bool = True        # accepted for config parity but IGNORED, matching
                                # the reference where AMP was dead code (quirk Q1);
                                # precision='bf16' is the explicit knob
    profile: bool = False
    clip: Optional[float] = None
    anomaly_detection: bool = False

    num_workers: int = 2        # host prefetch depth
    save_interval: int = 100
    start_epoch: int = 0
    test_iter: int = 5000

    # --- extensions of the JAX package ---
    precision: str = "fp32"     # 'fp32' | 'bf16' compute dtype for the model
    tc_impl: str = "xla"        # 'xla' (materialized) | 'blockwise' |
                                # 'pallas' (the fused TC kernels; CUDA here)
    tc_sampling: str = "stratified"  # 'stratified' (what the reference
                                # executes, ops.py:84) | 'weighted' (the
                                # minibatch-weighted estimator the
                                # reference defines but never calls,
                                # ops.py:92-101 — quirk Q11; xla impl only)
    kl_kind: Optional[str] = None  # override: 'gaussian' | 'tc' | 'tc_full'
    data_parallel: int = 0      # 0 = all local devices; N = mesh size
    model_parallel: int = 1     # tensor-parallel mesh axis size
    scan_steps: int = 1         # K train steps per [K, B, ...] transfer
    fuse_passes: Optional[bool] = None  # pair the intro step's independent
                                # passes into 2x-batch calls (per-group BN
                                # stats; numerics-identical, solvers/intro.py).
                                # None = auto; explicit true/false forces it
    pack_predict: int = -1      # decoder's 5x5 predict conv: >1 = pack NxN
                                # output pixels into channels (same math);
                                # -1 = auto (plain conv); 0 = plain conv
    remat: bool | str = False   # activation rematerialization:
                                # true/"block" per conv block; "pass" whole
                                # encode/decode passes of the intro step
    conv_impl: str = "auto"     # 3x3 conv execution: 'pallas' routes the
                                # 64->64 3x3 convs through the hand-written
                                # conv kernel; 'xla' keeps the stock conv;
                                # 'auto' resolves to 'xla'
    tile_rows: int = -1         # strip-tile convs whose input height is
                                # >= 2x this into H-strips stacked on the
                                # batch axis (same math); -1 = auto (off);
                                # 0 = off; N = strip height
    transfer_dtype: str = "auto"  # host->device batch transfer: 'auto'
                                # transfers raw uint8 when the dataset
                                # stores bit-exact uint8, else float32;
                                # 'float32'/'uint8' force a path
    device_cache: str = "auto"  # keep the whole uint8 dataset in device
                                # memory and gather batches on-device;
                                # 'auto' engages when it fits the budget,
                                # 'force' errors if it can't, 'off' streams
    device_cache_budget_mb: int = 4096  # per-device budget for that cache
    data_root: Optional[str] = None
    checkpoint_dir: str = "./saves"
    async_checkpoint: bool = False  # background checkpoint writes
    log_dir: Optional[str] = None
    resume: Optional[str] = None  # checkpoint path to resume from (fixes Q12)

    def fingerprint(self) -> str:
        """Checkpoint filename prefix — same hparam encoding as the
        reference (train.py:200)."""
        return (
            f"{self.solver}_{self.dataset}_betas_{self.beta_kl}_{self.beta_neg}_"
            f"{self.beta_rec}_{self.gamma_r}_zdim_{self.z_dim}_{self.arch}_"
            f"{self.optimizer}"
        )

    def run_comment(self) -> str:
        """TensorBoard run-name suffix (reference train.py:96)."""
        return (
            f"_{self.solver}_{self.dataset}_z{self.z_dim}_{self.beta_kl}_"
            f"{self.beta_neg}_{self.beta_rec}_{self.gamma_r}_{self.arch}_"
            f"{self.optimizer}"
        )


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def load_config(path: Optional[str] = None, update_dict: Optional[dict] = None) -> Config:
    """defaults <- JSON file <- update dict (reference config.py:66-72)."""
    c: dict = {}
    if path:
        if not os.path.isabs(path):
            path = os.path.abspath(path)
        with open(path) as f:
            c.update(json.load(f))
    c.update(update_dict or {})
    unknown = set(c) - _FIELD_NAMES
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return validate_config(Config(**c))


def validate_config(config: Config) -> Config:
    """Reject invalid enum-like values that would otherwise silently
    disable features (e.g. remat='Block' matching neither branch)."""
    if config.remat not in (False, True, "block", "pass"):
        raise ValueError(
            f"remat={config.remat!r}: expected False, True, 'block' or 'pass'"
        )
    if config.conv_impl not in ("auto", "xla", "pallas", "hybrid"):
        raise ValueError(
            f"conv_impl={config.conv_impl!r}: expected 'auto', 'xla', "
            "'pallas' or 'hybrid'"
        )
    if config.tc_sampling not in ("stratified", "weighted"):
        raise ValueError(
            f"tc_sampling={config.tc_sampling!r}: expected 'stratified' or 'weighted'"
        )
    if config.tc_sampling == "weighted" and config.tc_impl != "xla":
        raise ValueError(
            "tc_sampling='weighted' is only implemented for tc_impl='xla' "
            "(the reference never runs it at all — quirk Q11)"
        )
    return config
