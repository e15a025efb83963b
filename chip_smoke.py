#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (intro_tc_vae_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: compiles the TC kernels (intro_tc_vae_tpu_torch/csrc/
   tc_kernels.cu), the conv dW reduce (csrc/conv_kernels.cu), the bf16 3x3
   conv kernels (csrc/conv_wgmma.cu) and the fp32 3x3 conv kernels
   (csrc/conv_fp32.cu) from the checkout's sources, one nvcc each,
   and the native data core (runtime/data_core.cpp, g++), all started
   together, and loads them.
3. Kernels vs plain, TF32 off.
   TC: tc_fwd, tc_bwd_dz and tc_bwd_dmu against the plain PyTorch version
   (evaluated in float64 on the same inputs) at B in {64, 512}, Z=128,
   N=1280, at B=40, Z=72 (no multiple of a warp), at 37 rows from row 5
   of a bank of 90 (no multiple of a slice) and at B=48, Z=1024 (32
   latents a lane of tc_fwd), with the variance floor and the -50 clamp
   active; rtol 1e-4, atol 1e-5 on every element; two runs bit-equal.
   Median times of each kernel at B in {64, 512, 2048} (2048: time only)
   beside its bound (``tc_bounds``) and beside an empty kernel timed the
   same way, the launch floor; and of the float32 plain version. tc_fwd's
   targets (``TC_FWD_TARGETS``) are printed, not enforced.
   Conv: the wrappers conv3x3_fwd (forward and dx), conv3x3_dw (with
   conv3x3_dw_reduce) and conv3x3_pack_w at the flagship's shapes, NCHW
   [128, 64, 64, 64] and [128, 64, 32, 32], at [8, 64, 128, 128] (W = 128),
   at ``CONV_RAGGED_SHAPES`` in bf16 ([128, 64, 48, 48], [64, 64, 64, 36],
   [8, 64, 64, 96], [1, 64, 16, 1016], [2, 64, 16, 6], [3, 64, 20, 36]) and,
   in fp32, at [64, 64, 64, 64], [3, 64, 20, 36] and [2, 64, 16, 6] (rows
   that are no multiple of 16 bytes): the bf16 kernels' wgmma entry points
   (W in {32, 64, 128}), their ragged ones (the other bf16 shapes) and the
   fp32 bodies each against the plain version in float64 on the same
   (bf16-rounded) inputs; tolerances in ``conv_bound``; conv3x3_dw twice,
   bit-equal; launches exact. Median times, the kernels in turns beside
   cuDNN's forward, backward-data and backward-weight, the bounds and the
   launch floor, in bf16 at every bf16 shape above and fp32 (TF32 off);
   the fp32 bodies' targets (at or under cuDNN, at least half the bound)
   and the ragged entry points' aims (at or under cuDNN; at [128, 64, 48,
   48] at least 0.35 of the bound; at [2, 64, 16, 6] at most 3 launch
   floors) and zero-fill share are printed, not enforced; the kernels are
   named as ``conv_cuda.LAUNCHES`` counts them: conv3x3_fwd and
   conv3x3_dw are the fp32 bodies, conv3x3_fwd_wgmma / conv3x3_dw_wgmma
   and conv3x3_fwd_ragged / conv3x3_dw_ragged the bf16 entry points.
   BatchNorm (``phase_bn_kernels``): the five kernels of train-mode
   BatchNorm + leaky ReLU (csrc/bn_kernels.cu) through their autograd
   function against the float64 plain version (ops/batchnorm.py) at
   ``BN_CHECKS`` (the flagship's and the 128 px step's calls, bf16, fp32,
   fp16, planes of no whole vector), twice bit-equal; at ``BN_TIMED`` in
   bf16 each kernel's median time beside its bound (``bn_bounds``) and the
   launch floor, and the whole forward and backward of the kernels, the
   plain version and ``F.batch_norm`` + ``F.leaky_relu``; the targets
   (``BN_TARGETS``) printed, not enforced.
   TC gathered (``phase_gathered_kernels``): the same three kernels in
   their data-parallel form, each rank's rows against the whole mu bank of
   a global batch of 128 for R in {2, 8}, against the plain gathered
   version in float64 (rtol 1e-4, atol 1e-5); the ranks' outputs
   concatenated and their dmu summed against the single-device kernels;
   median times at R = 2.
4. Main path: ``intro_tc_vae_tpu_torch.main.cli`` trains the flagship
   recipe (configs/intro_tc_ukiyo64.json: 64x64x3, conv arch, channels
   64-512, z=128, batch 64, bf16, paired) on the synthetic dataset for one
   epoch = 20 steps in four arms: (tc_impl, conv_impl) = (pallas, xla),
   (xla, xla), (pallas, pallas), (pallas, hybrid). Every loss is finite;
   the launch counters of each phase of each step rise by exactly the
   counts derived in ``expected_intro_launches`` (the BatchNorm kernels'
   among them: 67 calls a step, every one through the kernels), and the
   run's total by those and the eval-mode decode after the last epoch
   (``final_decode_launches``). ``bn_calls_128``: the 128 px recipe, 7
   graphed steps, 81 train-mode BatchNorm calls a step through the
   kernels, none plain; an eval decode launches no BatchNorm kernel. The rates in img/s, steps after the first
   4 (a graphed step's 3 eager steps and its capture), each bound by the
   completion of the epoch's last step (the metrics are read on the host
   two steps behind the card). The step runs as one captured CUDA graph
   here and wherever the trainer graphs it (one process on the card:
   phases 4, 6, 8-13 and 15); every launch count of this script holds
   under replay, where each replay adds the graph's tally
   (``ops/launch_counts.py``) and the phase marks run between its
   segments. Every run of phases
   4-8 saves its checkpoints in a temporary directory, deleted
   afterwards.
5. In context, fp32, TF32 off. (a) One step with tc_impl 'pallas' and one
   with 'xla' from the same weights, batch and noise agree (metrics rtol
   1e-4, updated parameters atol 1e-5); as in phase 3, the 'xla' step
   evaluates the plain TC version in float64; the all-float32 'xla' step's
   distance is printed beside it. (b) One step with conv_impl 'pallas'
   and one with 'xla', same weights, batch and noise: metrics rtol 1e-4,
   updated parameters within 2 lr (Adam's first update is about
   lr sign(g)). (c) The flagship decoder's forward and backward in train
   and eval mode, conv_impl 'pallas' and 'xla' each against the float64
   decoder: output and every parameter gradient (tolerances in
   ``phase_decoder``).
6. The other paths at full width, each 20 steps through the CLI with
   conv_impl 'pallas' and then 'xla': configs/vae_synthetic.json (res
   arch, vae solver, fp32) and configs/tc_dsprites.json on the synthetic
   dataset with tc_impl 'pallas' (conv arch, tc solver, fp32). Finite
   losses, exact launch counts, img/s. Both are ``precision: "fp32"``, for
   which the trainer turns TF32 off: at every optimizer call of the runs
   both TF32 switches are off (checked), so both arms are true fp32.
7. The data-parallel path (``phase_data_parallel``):
   configs/intro_tc_128_dp8.json at full width on 2 ranks, two processes
   of this script (``--dp-rank``) that share the one card over gloo and
   train through the CLI's entry: (a) one epoch, 10 steps, with finite
   losses and exactly 5 gathered TC calls per step and rank (3 in phase
   E, 2 in phase D), 0 single-device TC calls and 0 conv kernels; (b) one
   fp32 step on the 2 ranks against one process on the whole batch; and
   phase 8 (g): the ranks' one final checkpoint (rank 0 writes it), loaded
   in this process, equals both ranks' parameters.
8. Checkpoint, resume and sampling at the flagship's full width
   (``phase_checkpoints``; (a)-(f) there, (g) in phase 7): the final
   checkpoint of a CLI run and the launches of its eval-mode decode, a
   bit-equal restore, a bit-equal step from the restored and the saved
   state, a background save equal to a synchronous one, ``resume: "auto"``
   continuing the step count, and the sampler CLI's PNG against the
   in-process decode; the save and load seconds and the checkpoint's
   bytes.
9. The data paths (``phase_data_paths``), in a temporary directory: a
   dSprites-layout npz (1,300 rows of 64x64 0/1 sprites) and an ARC
   Ukiyo-E-layout directory (1,280 procedural 256x256 JPEGs and the
   27-column CSV), written from a seeded RNG; the native data core loaded;
   per dataset one epoch through the loader's float32, uint8 and cache
   paths on the card, bit-equal to each other and to the host's float
   path, and the uint8 table against numpy's /255; configs/tc_dsprites.json
   through the CLI in the three data arms (losses agree, rtol 1e-5); the
   flagship config on its own ukiyo_e64 data with the cache engaged and
   phase 4's launch counts; the decode cache's seconds, host ms per batch
   and H2D bytes per step of each path, and the img/s beside phase 4's.

10. Observability and evaluation (``phase_observability``), in a
   temporary directory: the flagship config as shipped, TensorBoard on,
   tc and conv 'pallas', on phase 9's Ukiyo-E layout, written again (one
   epoch, test_iter 10: phase 4's launches plus the image grids' eval
   decodes, every tag read back through the port's tb_reader);
   configs/tc_dsprites.json on a dSprites layout on the full factor grid
   (dataset dsprites_small, one epoch, test_iter 56: MIG and modularity
   written, each sklearn-backed score written or failed for want of
   sklearn, the encodes on the card); ``evaluate --fid`` on the
   flagship's checkpoint with random Inception weights, and the Inception
   net on the card against the CPU. Prints the seconds of one test_iter's
   heavy metrics, the host ms of a drain's writes and Inception img/s.

11. The rest of the solver surface (``phase_solver_surface``), in a
   temporary directory: (a) the flagship recipe with arch 'inception'
   through the CLI, 20 steps, tc and conv 'pallas': finite losses, the TC
   kernels 3 + 2 calls x 3 kernels a step and no conv kernel, host img/s
   and device ms/step, and one fp32 step with the TC kernels against the
   float64 plain TC at phase 5's gate; (b) remat false, "block" and "pass"
   on the flagship (tc and conv 'pallas') through the trainer's setup, 7
   steps at batch 64 and at 256, cuDNN deterministic, each eager and then
   graphed: the launches of each phase equal ``expected_intro_launches``
   (recompute launches each routed conv's forward once more), "block" and
   "pass" bit-equal to false, graphed metrics bit-equal to eager, peak
   device memory and device ms/step of each, and the graphed peak within
   ``memory_gate``'s bound of the eager one (the graph's static buffers
   plus the allocator's fragmentation), nothing left allocated by a
   graphed run; (c) scan_steps 4 against 1 on
   an ARC Ukiyo-E layout with the device cache, 20 steps through the CLI:
   bit-equal, img/s of each; (d) kl_kind 'tc_full' and tc_sampling
   'weighted', one step each with the writer on: finite, the tc_decomp
   group read back through tb_reader.

12. The flagship recipe at 48 px (``phase_48px``): configs/
   intro_tc_ukiyo64.json's model, solver and optimizers (conv arch,
   64-128-256-512, z 128, batch 64, bf16, paired, Adam 2e-4, tc 'pallas')
   on Synthetic(image_size=48), built directly, in two arms, conv_impl
   'pallas' and 'xla' (cuDNN): 8 steps each from the same weights and
   batches; res_in_48's two convs route at [128, 64, 48, 48] to the ragged
   entry points, and the launches of each phase equal
   ``expected_intro_launches(routed=2, body="ragged")`` (16 forwards, 16
   packs, 4 dW and 4 reduces a step; tests/test_torch_conv.py derives the
   same on the CPU); one step of each arm from the same weights, batch and
   noise: metrics within sqrt(L) 2^-8 (L: the two networks' bf16-rounded
   layers), updated parameters within 2 lr (and fp32 rounding), BatchNorm's running statistics
   within sqrt(L) 2^-8 of each buffer's largest entry; device ms/step of
   both arms.

13. The model options, the reference loader and the doctor
   (``phase_options``), in a temporary directory, at the flagship's width:
   (a) ``pack_predict`` 0, 2 and 4 with tc and conv 'pallas' and (b)
   ``tile_rows`` 0 (conv 'xla'), 16 and 32 (conv 'pallas'), each 10 steps
   through the CLI on the synthetic set cut to 640 images
   (``synthetic_steps``): finite losses, the launches of each phase and
   of the run exactly as derived (``pack_predict`` leaves phase 4's;
   ``tile_rows`` > 0 routes no conv, so no conv kernel launches, as in
   JAX), device ms/step of each; cuDNN's plain 5x5 64 -> 3 predict conv
   against the packed form at b = 2 and 4 ([128, 64, 64, 64] bf16,
   forward and forward + backward); one fp32 step of ``pack_predict`` 2
   against 0 and of ``tile_rows`` 16 against 0 (conv 'xla') at phase 5
   (b)'s gate. (c) ``sample --pack 2`` and ``evaluate --pack 2`` on (a)'s
   ``pack_predict`` 0 checkpoint: the PNG within 2 levels of ``--pack
   0``'s, ``--pack 1`` bit-equal, evaluate's fakes within 1e-5. (d) That
   checkpoint written in the reference's format (``num_batches_tracked``,
   the dead ``conv_expand``) and loaded by ``load_torch_checkpoint``: an
   eval decode bit-equal to the source model's; a file without a key
   raises. (e) The doctor on the card: the flagship config, a dSprites
   and an ARC Ukiyo-E layout pass; an npz without ``latents_values`` and
   batch 4096 fail with exit 1; its activation estimate beside
   ``max_memory_allocated`` over 3 flagship steps at batch 64, remat
   false and "pass", eager and graphed, held to ``memory_gate``.

14. Tensor parallelism (``phase_tensor_parallel``), in temporary
   directories: the flagship at full width (tc and conv 'pallas', 10
   steps on the synthetic set cut to 640 images) in this process, then
   with ``model_parallel`` 2 on (a) 2 ranks (TP2 x DP1) and (b) 4 ranks
   (TP2 x DP2, ``data_parallel`` 4), processes of this script
   (``--tp-rank``) sharing the card over gloo, each through the CLI's
   entry: finite losses equal on all ranks; per rank the launches of each
   phase exactly phase 4's (the routed 64 -> 64 convs are never cut) and
   the TC's 5 calls a step on the single-device route (a) or the gathered
   one (b); replicated leaves bit-equal, the gathered state equal on all
   ranks; each rank's bytes of the state against the whole's and its peak
   device memory; device and wall ms/step per rank beside this process's
   (ranks that share a card: a cost, not a scaling figure). (c) One step
   of (b)'s ranks against one process on the whole batch, fp32 with the
   kernels (TF32 off; metrics rtol 1e-4, parameters within 2 lr plus one
   float32 rounding, as phase 7 (b); the four ranks also as data-parallel
   ranks without the model axis, for comparison) and float64 (tc and conv 'xla';
   metrics rtol 1e-6, parameters within 2 lr, BatchNorm statistics within
   rtol/atol 1e-6: forward statistics, which no lr bounds). (d) (b)'s one
   checkpoint holds the gathered state and decodes bit-equal in this
   process.

15. The graphed step (``phase_graphed_step``): the flagship (tc and conv
   'pallas', bf16, batch 64) through the trainer's setup, graphed against
   eager, cuDNN deterministic: (a) 20 steps, parameters, BatchNorm
   statistics, Adam states and every metric bit-equal; (b) both arms'
   launches per phase exact; (c) host img/s and device ms/step of both
   arms through ``train_soft_intro_vae``, in turns, twice; (d)
   ``intro_tc_vae_tpu_torch.analysis.profile_step`` on both arms (launches
   per step, host ms/step, idle share, device time by category) and the
   metric ring's pinned pool (drained metrics equal the steps' own); (e)
   ``scan_steps`` 4 graphed against 8 graphed steps, and a resume into the
   same graphed run (it captures again) against the uninterrupted run,
   both bit-equal.

16. The harnesses (``phase_harnesses``), in a temporary directory: every
   module of ``intro_tc_vae_tpu_torch.analysis`` ported with this phase
   through its entry point on the card. (a) ``bench_conv_kernel`` at
   [64, 64, 64, 64] bf16: its equality check (relative 3e-2 against cuDNN)
   and its launch check passed, the hand kernels launched in the pallas
   and hybrid arms and none in cuDNN's. (b) ``ceiling``: the flagship's
   operations a step equal to the closed form of its products and its TC
   calls, the sustained bf16 rate, and ``--measure`` (the kernels
   launched). (c) ``doctor_rehearsal``: exit codes 0, 0, 0, 1, 1, 1. (d)
   ``stability_report`` and ``run_vis`` on a 10-step flagship run with
   the writer on: every curve finite at every step. (e) ``model_vis``: its
   entry point, then encodes and traversal decodes on the card against the
   CPU (fp32, ``MODEL_VIS_RTOL``). (f) ``eval_config5_trend`` on
   synthetic128, 4 steps, 2 eval points: points at 0, 2, 4, finite, no
   .partial.json left. (g) ``scaling_comms`` on 2 ranks at the flagship's
   widths: bytes at the closed-form sites equal. A figure or projection
   that needs matplotlib or sklearn, where they do not import, is named
   as not drawn.

17. The benchmark program (``phase_bench``), ``intro_tc_vae_tpu_torch.bench``
   through its functions: (a) ``main`` on the flagship (batch 64, bf16,
   paired) in the arms (tc, conv) = (xla, xla) and (pallas, pallas), each
   graphed and eager, 3 warm-up calls (and the graph's 3 eager steps and
   its capture) and 30 timed steps: every step's losses finite, the
   launches of each phase exactly phase 4's arm's scaled to the steps
   run, img/s and ms/step on the card's clock (CUDA events) printed. (b)
   ``infer`` at batch 256 with ``--pack`` 0 and 4, graphed and eager,
   img/s; each surface (decode, encode, decode_u8) graphed bit-equal to
   its eager pass on two inputs, before and after BatchNorm's running
   statistics move in place; a graphed run leaves 0 MiB allocated once it
   is gone (``memory_of``). (c) ``headline()``, its fast path once (and the full
   sweep, should its two configurations land within 2 %): every arm
   finite, its JSON line printed. (d) The solver's eval encoder on the
   flagship: captured at batch 64 and a remainder of 17, then 20 graphed
   train steps, then its replays bit-equal to the eager encoder; the eval
   graphs' memory (allocated, reserved by their pools, the capture's peak)
   and two encodes' peak beside the graphed step's; one test_iter's MIG and
   modularity seconds, eager and graphed (the sklearn-backed
   explicitness fails on a host without sklearn, as in phase 10).

Each phase prints its seconds. Then one JSON line describing the kernels,
and as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --memory`` instead builds the kernels and runs
MEMORY_RUNS: the flagship's peak device memory eager (Adam capturable and
not) and graphed (warm-up only; through a capture and 5 replays), each
run's blocks live at its peak by site against the eager run's, and what
each run leaves allocated once it is gone.

``python3 chip_smoke.py --device-time`` instead builds the kernels and
profiles the flagship's four arms, and then configs/vae_synthetic.json
(fp32) with conv_impl 'pallas' and 'xla', in turns (torch.profiler, 5
steady steps each, twice): device ms per step and the conv kernels' share,
with the TF32 switches as each run sets them (off in the fp32 runs).
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(HERE, "configs", "intro_tc_ukiyo64.json")
VAE_SYNTHETIC = os.path.join(HERE, "configs", "vae_synthetic.json")
TC_DSPRITES = os.path.join(HERE, "configs", "tc_dsprites.json")
DP_CONFIG = os.path.join(HERE, "configs", "intro_tc_128_dp8.json")
DP_RANKS, DP_TIMEOUT, DP_DEVICE = 2, 300, "cuda:0"  # the ranks share card 0
# conv3x3_fwd_wgmma and conv3x3_dw_wgmma: the bf16 kernels' entry points the
# flagship's shapes take; conv3x3_fwd_ragged and conv3x3_dw_ragged: the same
# kernels' entry points for every other bf16 width (phase 12's launches);
# conv3x3_fwd and conv3x3_dw: the fp32 bodies (phase 6's launches)
SOURCE = {
    "tc_fwd": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "tc_bwd_dz": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "tc_bwd_dmu": "intro_tc_vae_tpu_torch/csrc/tc_kernels.cu",
    "conv3x3_fwd_wgmma": "intro_tc_vae_tpu_torch/csrc/conv_wgmma.cu",
    "conv3x3_dw_wgmma": "intro_tc_vae_tpu_torch/csrc/conv_wgmma.cu",
    "conv3x3_fwd_ragged": "intro_tc_vae_tpu_torch/csrc/conv_wgmma.cu",
    "conv3x3_dw_ragged": "intro_tc_vae_tpu_torch/csrc/conv_wgmma.cu",
    "conv3x3_dw_reduce": "intro_tc_vae_tpu_torch/csrc/conv_kernels.cu",
    "conv3x3_pack_w": "intro_tc_vae_tpu_torch/csrc/conv_wgmma.cu",
    "conv3x3_fwd": "intro_tc_vae_tpu_torch/csrc/conv_fp32.cu",
    "conv3x3_dw": "intro_tc_vae_tpu_torch/csrc/conv_fp32.cu",
    **dict.fromkeys(("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"),
                    "intro_tc_vae_tpu_torch/csrc/bn_kernels.cu"),
}
REPLACES = {
    "tc_fwd": "intro_tc_vae_tpu/ops/tc_pallas.py:109",
    "tc_bwd_dz": "intro_tc_vae_tpu/ops/tc_pallas.py:174",
    "tc_bwd_dmu": "intro_tc_vae_tpu/ops/tc_pallas.py:202",
    "conv3x3_fwd": "intro_tc_vae_tpu/ops/conv_pallas.py:238",
    "conv3x3_dw": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
    # the TPU grid summed dW across its ordered steps inside _dwp_kernel
    "conv3x3_dw_reduce": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
    # the TPU kernels read weights packed by pack_weights (and _rot_t, :143)
    "conv3x3_pack_w": "intro_tc_vae_tpu/ops/conv_pallas.py:112",
    "conv3x3_fwd_wgmma": "intro_tc_vae_tpu/ops/conv_pallas.py:238",
    "conv3x3_dw_wgmma": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
    "conv3x3_fwd_ragged": "intro_tc_vae_tpu/ops/conv_pallas.py:238",
    "conv3x3_dw_ragged": "intro_tc_vae_tpu/ops/conv_pallas.py:253",
    # new kernels: the JAX package leaves BatchNorm to XLA (PERF.md section 6)
    **dict.fromkeys(("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"),
                    "none: train-mode BatchNorm + leaky ReLU, XLA's on the TPU"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bound_ms of
# a kernel is max(bytes / HBM_BYTES_S, operations / peak of their type),
# each input read once and each output written once.
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "fp64": 34e12}  # fp64 without tensor cores
RTOL, ATOL = 1e-4, 1e-5
Z_DIM, DATASET_SIZE, MAIN_B = 128, 1280, 64
LR = 2e-4
# the flagship's paired decoder calls: x [2B, 64, 64, 64] (res_in_64.conv1,
# .conv2) and [2B, 64, 32, 32] (res_in_32.conv2)
CONV_SHAPES = ((2 * MAIN_B, 64, 64, 64), (2 * MAIN_B, 64, 32, 32))
CONV_WIDE = (8, 64, 128, 128)    # W = 128 (intro_tc_128_dp8's routed width): two boxes a row
CONV_RAGGED = (3, 64, 20, 36)    # no multiple of any kernel's tile; H free
CONV_NARROW = (2, 64, 16, 6)     # the gate's narrow end: rows of 24 bytes
CONV_48 = (2 * MAIN_B, 64, 48, 48)  # phase 12's routed convs: one part-filled box
# the bf16 shapes of the ragged entry points phase 3 checks and times:
# phase 12's; W % 8 = 4 (rows TMA cannot land); a full and a part-filled
# box; 16 boxes a row (H * W = 16,256); the narrow end; the ragged shape
CONV_RAGGED_SHAPES = (CONV_48, (64, 64, 64, 36), (8, 64, 64, 96), (1, 64, 16, 1016),
                      CONV_NARROW, CONV_RAGGED)
# the larger routed shape of vae_synthetic and tc_dsprites (fp32, batch 64,
# one pass): what the fp32 bodies are timed and bounded at
CONV_FP32_PATH = (MAIN_B, 64, 64, 64)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def tf32_flags() -> tuple:
    """(cuDNN convs, matrix products): may fp32 work run in TF32 now?"""
    import torch

    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def tf32_at_optimizer_calls():
    """Collects ``tf32_flags()`` at every optimizer update of the runs made
    inside the block (``launch_counts.on_mark``: eager steps and graph
    replays alike): the switches as the steps ran under them."""
    from intro_tc_vae_tpu_torch.ops import launch_counts

    seen = set()
    handle = launch_counts.on_mark(lambda: seen.add(tf32_flags()))
    try:
        yield seen
    finally:
        handle.remove()


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convs (cuDNN runs fp32 convs in TF32
    by default) and deterministic cuDNN algorithms; restored on exit."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def median_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over `reps` of the CUDA-event time of `inner` back-to-back
    calls, per call, after a warm-up, behind a device sleep
    (``intro_tc_vae_tpu_torch/analysis/_timing.py``, which the harnesses
    share): the events bracket device time and not the host's enqueue (a
    wrapper takes 20-90 us of host time, more than some of the kernels)."""
    from intro_tc_vae_tpu_torch.analysis._timing import median_ms as timed

    return timed(fn, "cuda", reps=reps, inner=inner)


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by of a kernel from the bytes it must move and the
    operations (of type `kind`) it does."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / PEAK_OPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Operations of the TC kernels as the data sheet counts them (a fused
# multiply-add is two). A float64 exp is software: round x / ln 2 to k (one
# fused multiply-add and an add), x - k ln 2 with ln 2 in two parts (two), a
# polynomial of degree 11 in Horner form (eleven); putting k into the exponent
# is integer work: 14 fused multiply-adds and an add, 29, for the CUDA
# library's exp and for the kernels' own alike (a shorter polynomial does not
# keep the train step: csrc/tc_kernels.cu::exp_in_range). The density of a
# pair (j, i, l): z - mu, times 1/v, times d, c - 0.5 d^2/v: 5.
TC_EXP_OPS, TC_DENSITY_OPS = 29, 5
TC_OPS = {
    # per (j, i, l): density, clamp, exp, two sums (the marginal's and
    # psum's); per (j, i): the joint term's + iw, max, - max, exp, sum. What
    # the function needs: the marginal's exponents have a shift known in
    # advance, so no element needs a max or its own + iw
    "tc_fwd": (TC_DENSITY_OPS + 1 + TC_EXP_OPS + 2, 4 + TC_EXP_OPS),
    # per (j, i, l): density, the clamp's compare, the exponent (one fma), exp,
    # dP (fma), the dz product (fma), d^2/v - 1 and the dlogvar product (fma);
    # per (j, i): the joint weight's exponent (two adds), exp, times g_j
    "tc_bwd_dz": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2 + 3, 3 + TC_EXP_OPS),
    "tc_bwd_dmu": (TC_DENSITY_OPS + 1 + 2 + TC_EXP_OPS + 2 + 2, 3 + TC_EXP_OPS),
}
# tc_fwd's count before, with + iw, a running max and - max per (j, i, l):
# a share of the bound under it compares with the shares printed before
TC_FWD_OPS_OLD = (TC_DENSITY_OPS + 4 + TC_EXP_OPS + 2, 4 + TC_EXP_OPS)


def tc_bounds(b: int, bank: int, zdim: int = 128, ops: dict | None = None) -> dict:
    """Bounds of the TC kernels (those of `ops`, default TC_OPS) for b rows
    against a bank of `bank`. Operations: `ops` per (row, bank row, latent)
    and per (row, bank row),
    all float64, at the data sheet's fp64 rate. Bytes, each input read once
    and each output written once: z, mu, logvar, dz, dlogvar, dmu, pm, qz,
    g_m, g_j in float32; terms [b, Z, 4], psum [b, bank] and lj [b], which
    the forward writes and each backward kernel reads, in float64. At the
    training shape the bound is under a microsecond, below what a launch
    costs: there a kernel is judged against the launch floor (phase 3)."""
    rows, bank_rows = b * zdim * 4, bank * zdim * 4
    kept = b * zdim * 32 + b * bank * 8 + b * 8
    moved = {"tc_fwd": 2 * rows + bank_rows + kept + 2 * b * 4,
             "tc_bwd_dz": kept + bank_rows + rows + 2 * b * 4 + 2 * rows,
             "tc_bwd_dmu": kept + bank_rows + 2 * b * 4 + bank_rows}
    return {k: bound(moved[k], b * bank * (zdim * per_pair + per_row_pair), "fp64")
            for k, (per_pair, per_row_pair) in (ops or TC_OPS).items()}


def conv_bounds(shape, kind: str, n_parts: int) -> dict:
    """Bounds of the conv kernels on activations `shape` of `kind` (bf16 or
    fp32), the same for every body of a wrapper: forward
    and dW each do 2 x 64 x 576 operations a pixel; the forward reads x and
    w and writes y; dW, the function, reads x and gy and writes the
    [64, 64, 3, 3] weights' gradient. The n_parts fp32 partials between the
    dW kernel and its reduce (n_parts x 147 KB written and read again: 18.9
    MB each way at 128 partials, 37.7 MB at 256) are the implementation's
    own traffic and part of no bound of conv3x3_dw: they are why it cannot
    reach it. ``conv3x3_dw+reduce`` is the same function's bound for the
    pair of kernels that computes it. conv3x3_dw_reduce alone, as a function
    of the partials it is handed, reads them and writes dW; the pack reads
    and writes the weights."""
    n, c, h, w = shape
    size = 2 if kind == "bf16" else 4
    act, wts, part = n * c * h * w * size, 64 * 64 * 9 * size, n_parts * 576 * 64 * 4
    ops = 2.0 * n * h * w * 64 * 576
    return {"conv3x3_fwd": bound(2 * act + wts, ops, kind),
            "conv3x3_dw": bound(2 * act + wts, ops, kind),
            "conv3x3_dw+reduce": bound(2 * act + wts, ops, kind),
            "conv3x3_dw_reduce": bound(part + wts, n_parts * 576 * 64, "fp32"),
            "conv3x3_pack_w": bound(2 * wts, 0, kind)}


def tc_inputs(b: int, seed: int, zdim: int = Z_DIM, check: bool = True):
    """z, mu, logvar [b, zdim] from numpy; logvar scaled x4 as in
    tests/test_tc_impls.py:170 so the 1e-4 variance floor and the -50
    clamp are both active (checked, unless the [b, b, zdim] densities of the
    check are too large to make on the host)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    z = rng.randn(b, zdim).astype(np.float32)
    mu = rng.randn(b, zdim).astype(np.float32)
    logvar = (rng.randn(b, zdim) * 0.7 * 4.0).astype(np.float32)
    if not check:
        return z, mu, logvar
    v = np.maximum(np.exp(logvar), 1e-4)
    lp = -0.5 * (np.log(v)[:, None] + (z[:, None] - mu[None]) ** 2 / v[:, None]
                 + np.log(2 * np.pi))
    if not ((np.exp(logvar) < 1e-4).any() and (lp < -50).any()):
        die(f"B={b}: inputs do not reach the variance floor and the clamp")
    return z, mu, logvar


def tc_loss(pm, qz):
    # weights the two outputs differently so both incoming gradients matter
    return (qz - pm).mean() + 0.5 * pm.sum() * 1e-3


TC_TIMED = (MAIN_B, 512, 2048)   # batches the TC kernels are timed at
# correctness only, (rows, row_off, bank, Z): a Z that is no multiple of 32;
# rows and a bank that differ and are no multiple of a slice or a chunk; Z =
# 1024, the largest the kernels take (32 latents a lane of tc_fwd)
TC_RAGGED = ((40, 0, 40, 72), (37, 5, 90, 72), (48, 0, 48, 1024))
# tc_fwd's targets at Z = 128 (ms, or a ratio), printed beside its times:
# at most 3x the launch floor at B = 64, twice as fast as 0.30574 ms at
# B = 512, half its bound (TC_OPS) at B = 2048; gathered (R = 2, rank 1) at
# most 0.010 ms, the three kernels summed at most 0.025 ms
TC_FWD_TARGETS = {"B=64 time / launch floor": 3.0, "B=512 ms": 0.30574 / 2,
                  "B=2048 bound / time": 0.5, "gathered ms": 0.010,
                  "gathered three kernels ms": 0.025}


def tc_dataset_size(bank: int) -> int:
    """N of a timed or checked TC call: the main path's, or 20 banks where
    the bank outgrows it (the stratified weights need N >= B)."""
    return DATASET_SIZE if bank <= DATASET_SIZE else 20 * bank


def time_tc_kernels(arrays, b: int, off: int, dev) -> dict:
    """Median ms of each TC kernel launched alone on rows [off, off + b) of
    z and logvar against the whole mu bank, the backward kernels on what the
    forward left; and of an empty kernel timed the same way: the launch
    floor."""
    import torch

    from intro_tc_vae_tpu_torch.ops import tc_cuda

    z, mu, logvar = (torch.tensor(a, device=dev) for a in arrays)
    gb, zdim = mu.shape
    z, logvar = z[off:off + b].contiguous(), logvar[off:off + b].contiguous()
    terms, psum, lj = tc_cuda.forward_buffers(b, gb, zdim, dev)
    pm, qz = torch.empty(b, device=dev), torch.empty(b, device=dev)
    g_m = torch.full((b,), -1.0 / gb + 5e-4, device=dev)
    g_j = torch.full((b,), 1.0 / gb, device=dev)
    dz, dlv, dmu = torch.empty_like(z), torch.empty_like(z), torch.empty_like(mu)
    tensors = {"tc_fwd": (z, mu, logvar, terms, psum, lj, pm, qz),
               "tc_bwd_dz": (terms, mu, logvar, psum, lj, g_m, g_j, dz, dlv),
               "tc_bwd_dmu": (terms, mu, psum, lj, g_m, g_j, dmu)}
    common = (b, gb, zdim, tc_dataset_size(gb), dev, off)
    t = {}
    for name in tc_cuda.KERNELS:
        t[name] = median_ms(lambda: tc_cuda.launch(name, tensors[name], *common))
    t["launch_floor"] = median_ms(lambda: tc_cuda.launch_empty(dev))
    return t


def tc_run(fn, dtype, arrays, rows, dev, *extra) -> dict:
    """pm, qz and the three gradients of the rows' share of tc_loss, as
    float64 numpy."""
    import torch

    gb = arrays[1].shape[0]
    args = [torch.tensor(a, device=dev, dtype=dtype, requires_grad=True)
            for a in (arrays[0][rows], arrays[1], arrays[2][rows])]
    pm, qz = fn(*args, *extra)
    ((qz - pm).sum() / gb + 0.5e-3 * pm.sum()).backward()  # tc_loss, the rows' share
    torch.cuda.synchronize()
    z, mu, logvar = args
    return {k: v.detach().double().cpu().numpy() for k, v in
            {"pm": pm, "qz": qz, "dz": z.grad, "dlogvar": logvar.grad,
             "dmu": mu.grad}.items()}


TC_OWNER = {"pm": "tc_fwd", "qz": "tc_fwd", "dz": "tc_bwd_dz", "dlogvar": "tc_bwd_dz",
            "dmu": "tc_bwd_dmu"}


def phase_kernels(card: str) -> dict:
    """Phase 3: each kernel against the plain version; returns per-kernel
    max_abs_err (over every checked shape) and times at the main path's B.

    The plain version is evaluated in float64 on the same float32 inputs:
    in float32 it carries ~4e-5 of rounding on small gradient entries
    where the variance is floored (see csrc/tc_kernels.cu, "Precision"),
    more than the 1e-5 held here. Its float32 difference is printed too.
    Every shape runs the kernels twice: the two results are bit-equal.
    """
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.ops import tc_cuda

    dev = torch.device("cuda", 0)
    errs = dict.fromkeys(tc_cuda.KERNELS, 0.0)
    fwd = {}  # tc_fwd at each timed B: ms, bound ms, launch floor ms

    def check(b, off, gb, zdim):
        """Rows [off, off + b) of a bank of gb: kernels (single-device form
        where the rows are the bank) twice, and the float64 plain version."""
        arrays = tc_inputs(gb, seed=gb, zdim=zdim)
        rows, n = slice(off, off + b), tc_dataset_size(gb)
        if (b, off) == (gb, 0):
            kernel, plain, extra = (tc_cuda.tc_logsumexp_cuda,
                                    tc_cuda.tc_logsumexp_reference, (n,))
        else:
            kernel, plain, extra = (tc_cuda.tc_logsumexp_cuda_gathered,
                                    tc_cuda.tc_logsumexp_reference_gathered, (off, n, gb))
        got = tc_run(kernel, torch.float32, arrays, rows, dev, *extra)
        again = tc_run(kernel, torch.float32, arrays, rows, dev, *extra)
        want = tc_run(plain, torch.float64, arrays, rows, dev, *extra)
        plain32 = tc_run(plain, torch.float32, arrays, rows, dev, *extra)
        where = f"B_j={b} row_off={off} B_i={gb} Z={zdim}"
        for key, kernel_name in TC_OWNER.items():
            g, w = got[key], want[key]
            if not np.isfinite(g).all():
                die(f"{kernel_name}: non-finite {key} at {where}")
            if not np.array_equal(g, again[key]):
                die(f"{kernel_name}: two runs differ in {key} at {where}")
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kernel_name} {key} {where}")
            errs[kernel_name] = max(errs[kernel_name], float(np.abs(g - w).max()))
        print(f"phase 3: {where}: two runs bit-equal; max abs diff to the float64 plain "
              "version: kernels "
              + json.dumps({k: float(np.abs(got[k] - want[k]).max()) for k in TC_OWNER})
              + ", float32 plain version "
              + json.dumps({k: float(np.abs(plain32[k] - want[k]).max()) for k in TC_OWNER}))
        return arrays

    for shape in TC_RAGGED:
        check(*shape)
    times = {}
    for b in TC_TIMED:
        # 2048: time only (the plain version's [B, B, Z] tensors are 2 GB each)
        plain = b <= 512
        arrays = check(b, 0, b, Z_DIM) if plain else tc_inputs(b, seed=b, check=False)
        t = time_tc_kernels(arrays, b, 0, dev)
        if plain:
            # the float32 plain forward and backward (what tc_impl 'xla' runs)
            z, mu, logvar = (torch.tensor(a, device=dev) for a in arrays)
            with torch.no_grad():
                t["plain_fwd"] = median_ms(
                    lambda: tc_cuda.tc_logsumexp_reference(z, mu, logvar, DATASET_SIZE))
            args = [x.clone().requires_grad_(True) for x in (z, mu, logvar)]
            loss = tc_loss(*tc_cuda.tc_logsumexp_reference(*args, DATASET_SIZE))
            t["plain_bwd"] = median_ms(
                lambda: torch.autograd.grad(loss, args, retain_graph=True))
        bounds = tc_bounds(b, b)
        print(f"phase 3: B={b} Z={Z_DIM} N={tc_dataset_size(b)} median ms per call "
              + json.dumps({k: round(v, 5) for k, v in t.items()})
              + "; bound ms " + json.dumps({k: round(v["bound_ms"], 5)
                                            for k, v in bounds.items()})
              + "; bound / time " + json.dumps({k: round(v["bound_ms"] / t[k], 3)
                                                for k, v in bounds.items()})
              + "; time / launch floor "
              + json.dumps({k: round(t[k] / t["launch_floor"], 2) for k in bounds})
              + f" on {card}")
        old = tc_bounds(b, b, ops={"tc_fwd": TC_FWD_OPS_OLD})["tc_fwd"]["bound_ms"]
        print(f"phase 3: B={b} tc_fwd bound / time under its earlier count "
              f"({TC_FWD_OPS_OLD[0]} a (j, i, l), for comparison with earlier shares): "
              f"{old / t['tc_fwd']:.3f} on {card}")
        fwd[b] = (t["tc_fwd"], bounds["tc_fwd"]["bound_ms"], t["launch_floor"])
        if b == MAIN_B:
            times = t
    print("phase 3: kernels match the plain version (rtol 1e-4, atol 1e-5, TF32 off); "
          "max abs err " + json.dumps(errs))
    return {"errs": errs, "times": times, "fwd": fwd}


def phase_gathered_kernels(card: str) -> dict:
    """Phase 3, gathered: the three TC kernels in their data-parallel form
    (tc_logsumexp_cuda_gathered), one process standing in for each rank r
    of R in {2, 8} over a global batch of GB = 128: z, logvar rows
    r*GB/R.. against the whole mu bank [GB, Z], row_off = r*GB/R. Each
    rank's loss is its rows' share of the global loss, so its gradients
    are its part of the global ones.

    Checks: each against the plain gathered version in float64 (rtol
    1e-4, atol 1e-5); the ranks' pm, qz, dz and dlogvar rows,
    concatenated, bit-equal to the single-device kernels on the whole
    batch (each block redoes the same row's slices, only the row's weight
    index is offset: the order of every sum follows from the bank's length
    alone); the sum over ranks of the full-bank dmu equal to the
    single-device dmu within the same tolerance (R float32 roundings).
    Returns max_abs_err and the median times at R = 2, rank 1."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.ops import tc_cuda

    dev = torch.device("cuda", 0)
    gb = 2 * MAIN_B
    arrays = tc_inputs(gb, seed=gb)

    def run(fn, dtype, rows, *extra):
        return tc_run(fn, dtype, arrays, rows, dev, *extra)

    whole = run(tc_cuda.tc_logsumexp_cuda, torch.float32, slice(None), DATASET_SIZE)
    err = 0.0
    for world in (2, 8):
        b = gb // world
        parts, dmu = [], 0.0
        for r in range(world):
            rows = slice(r * b, (r + 1) * b)
            extra = (r * b, DATASET_SIZE, gb)
            got = run(tc_cuda.tc_logsumexp_cuda_gathered, torch.float32, rows, *extra)
            want = run(tc_cuda.tc_logsumexp_reference_gathered, torch.float64, rows, *extra)
            for key, g in got.items():
                if g.shape != want[key].shape or not np.isfinite(g).all():
                    die(f"gathered {key} R={world} r={r}: shape {g.shape} or non-finite")
                np.testing.assert_allclose(g, want[key], rtol=RTOL, atol=ATOL,
                                           err_msg=f"gathered {key} R={world} r={r}")
                err = max(err, float(np.abs(g - want[key]).max()))
            parts.append(got)
            dmu = dmu + got["dmu"]
        for key in ("pm", "qz", "dz", "dlogvar"):
            cat = np.concatenate([p[key] for p in parts])
            if not np.array_equal(cat, whole[key]):
                die(f"gathered R={world}: the ranks' {key} rows differ from the single-device "
                    f"kernel by {float(np.abs(cat - whole[key]).max())!r}")
        np.testing.assert_allclose(dmu, whole["dmu"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"gathered R={world}: summed dmu")
        print(f"phase 3: gathered R={world}: {world} ranks x {b} rows against the "
              f"[{gb}, {Z_DIM}] bank match the float64 plain version; their pm, qz, dz, "
              f"dlogvar rows equal the single-device kernels' bit for bit; summed dmu "
              f"within {float(np.abs(dmu - whole['dmu']).max()):.3g} of the single-device dmu")

    # times at R = 2, rank 1: each kernel alone, and the float32 plain version
    b, off = gb // 2, gb // 2
    t = time_tc_kernels(arrays, b, off, dev)
    z, mu, logvar = (torch.tensor(a, device=dev) for a in arrays)
    z, logvar = z[off:].contiguous(), logvar[off:].contiguous()
    plain = tc_cuda.tc_logsumexp_reference_gathered
    with torch.no_grad():
        t["plain_fwd"] = median_ms(lambda: plain(z, mu, logvar, off, DATASET_SIZE, gb))
    args = [x.clone().requires_grad_(True) for x in (z, mu, logvar)]
    pm_p, qz_p = plain(*args, off, DATASET_SIZE, gb)
    loss = (qz_p - pm_p).sum() / gb + 0.5e-3 * pm_p.sum()
    t["plain_bwd"] = median_ms(lambda: torch.autograd.grad(loss, args, retain_graph=True))
    t["kernels"] = t["tc_fwd"] + t["tc_bwd_dz"] + t["tc_bwd_dmu"]
    t["plain"] = t["plain_fwd"] + t["plain_bwd"]
    print(f"phase 3: gathered R=2 rank 1 ({b} rows, bank {gb}) Z={Z_DIM} N={DATASET_SIZE} "
          "median ms per call " + json.dumps({k: round(v, 5) for k, v in t.items()})
          + f" on {card}; max abs err {err:.3g}")
    return {"err": err, "times": t}


def conv_bound(name: str, dtype, ref, s):
    """Largest |kernel - float64 plain| allowed per entry; s is the same
    conv of the operands' absolute values (each entry's sum of |terms|).

    fp32: rtol 1e-4 / atol 1e-5 for y and dx (576 terms an entry). dW
    sums 524,288 products at [128, 64, 64, 64]; a thread of the fp32
    kernel adds its block's pixels one at a time, 8 units x 512 pixels =
    4,096 sequential fp32 additions on 132 blocks, and the reduce then
    adds 132 partials in order: a chain of 4,228. The random-walk
    estimate sqrt(4228) * 2^-24 = 3.9e-6 s sits under 2e-5 s with a 5x
    margin (the worst case, every rounding the same way, is 4228 * 2^-24
    = 2.5e-4 s). The bound is the one the shorter chain of the kernel
    before it (2,304 additions, 2.9e-6 s, 7x) was held to; it is kept,
    not widened.
    bf16: one rounding of the fp32 sum, at most 2^-8 |ref| (bf16 keeps 8
    significant bits), plus 1e-5 s for the fp32 sum before it. For y and
    dx that sum has 576 terms. For dW the bf16 kernel's chain is short
    (at every shape phase 3 checks): a block adds one wgmma (a 16-term tree) per 16
    pixels of its rows into the accumulator, 64 rows x 4 = 256 sequential
    additions for the one unit a block walks at [128, 64, 64, 64] (at most
    4 x that where a block walks 4 units), then at most 132 partials in
    order: 388 sequential additions, random walk sqrt(388) * 2^-24 = 1.2e-6
    s, which the same 1e-5 s holds with an 8x margin (worst case 2.3e-5
    s); it is kept, not widened. The ragged entry points' longest chain is
    at [128, 64, 48, 48]: 48 rows x 3 k-steps a block, then 128 partials,
    272 additions."""
    import torch

    if dtype == torch.bfloat16:
        return 2.0 ** -8 * ref.abs() + 1e-5 * s
    if name == "dw":
        return 2e-5 * s
    return RTOL * ref.abs() + ATOL


def fill_share(w: int) -> tuple:
    """(forward, dW) share of the bf16 kernels' tensor-core work at width w
    that multiplies zero-fill: the forward multiplies whole boxes (ceil(W /
    BW) boxes of BW pixels a row), dW the k-steps of 16 pixels that hold a
    pixel of the image (csrc/conv_wgmma.cu)."""
    from intro_tc_vae_tpu_torch.ops import conv

    bw, boxes = conv.box_width(w), conv.box_columns(w)
    k_steps = sum(-(-min(bw, w - i * bw) // 16) for i in range(boxes))
    return 1 - w / (boxes * bw), 1 - w / (16 * k_steps)


def phase_conv_kernels(card: str) -> dict:
    """Phase 3, conv: the wgmma entry points (bf16, W in {32, 64, 128}),
    the ragged ones (every other bf16 shape) and the fp32 bodies of each
    kernel against the float64 plain version (TF32 off); returns per-kernel
    max_abs_err (conv3x3_fwd and conv3x3_dw: the fp32 bodies'), the times
    and the bounds."""
    import torch

    from intro_tc_vae_tpu_torch.ops import conv, conv_cuda, tc_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = dict.fromkeys(conv_cuda.KERNELS, 0.0)

    # conv3x3_pack_w moves values: equal to the plain version bit for bit,
    # [tap][co][ci] in bf16 and [tap][ci][co] in fp32
    w32 = torch.randn((64, 64, 3, 3), device=dev, generator=gen) * 0.05
    for w in (w32.to(bf16), w32):
        co_inner = w.dtype == fp32
        for rot in (False, True):
            plain = conv.pack_weights(w, rot, co_inner)
            if not torch.equal(conv_cuda.conv3x3_pack_w(w, rot), plain):
                die(f"conv3x3_pack_w({w.dtype}, rot={rot}) differs from the plain pack_weights")
            if not torch.equal(conv.unpack_weights(plain, co_inner),
                               conv.rot_t(w) if rot else w):
                die(f"pack_weights({w.dtype}, rot={rot}) is not the weights it stands for")

    checks = [(shape, bf16) for shape in (*CONV_SHAPES, CONV_WIDE, *CONV_RAGGED_SHAPES)]
    checks += [(shape, fp32) for shape in
               (*CONV_SHAPES, CONV_WIDE, CONV_FP32_PATH, CONV_RAGGED, CONV_NARROW)]
    for shape, dtype in checks:
        body = conv.kernel_body(shape, dtype)
        if body != ("fp32" if dtype == fp32 else "wgmma" if shape[3] in conv.FAST_WIDTHS
                    else "ragged"):
            die(f"kernel_body({shape}, {dtype}) is {body}")
        x = (torch.randn(shape, device=dev, generator=gen) * 0.5).to(dtype)
        w = (torch.randn((64, 64, 3, 3), device=dev, generator=gen) * 0.05).to(dtype)
        gy = torch.randn(shape, device=dev, generator=gen).to(dtype)
        conv_cuda.reset_launch_counts()
        got = {"y": conv_cuda.conv3x3_fwd(x, w),
               "dx": conv_cuda.conv3x3_fwd(gy, w, rot=True),
               "dw": conv_cuda.conv3x3_dw(x, gy)}
        again = conv_cuda.conv3x3_dw(x, gy)
        torch.cuda.synchronize()
        want_launches = conv_launches(2, 2, body)
        if conv_cuda.LAUNCHES != want_launches:
            die(f"conv {shape} {dtype}: launches {conv_cuda.LAUNCHES}, expected {want_launches}")
        if not torch.equal(got["dw"], again):
            die(f"conv3x3_dw {shape} {dtype}: two runs differ")
        suffix = "" if body == "fp32" else f"_{body}"
        owner = {"y": "conv3x3_fwd" + suffix, "dx": "conv3x3_fwd" + suffix,
                 "dw": "conv3x3_dw" + suffix}
        xd, wd, gd = x.double(), w.double(), gy.double()
        want = {
            "y": (conv.conv3x3_reference(xd, wd),
                  conv.conv3x3_reference(xd.abs(), wd.abs())),
            "dx": (conv.conv3x3_dx_reference(gd, wd),
                   conv.conv3x3_dx_reference(gd.abs(), wd.abs())),
            "dw": (conv.conv3x3_dw_reference(xd, gd),
                   conv.conv3x3_dw_reference(xd.abs(), gd.abs())),
        }
        report = {}
        for name, (ref, s) in want.items():
            g = got[name]
            if g.dtype != dtype or g.shape != ref.shape or not bool(torch.isfinite(g).all()):
                die(f"{owner[name]} {name} {shape} {dtype}: dtype {g.dtype}, shape "
                    f"{tuple(g.shape)}, or non-finite values")
            d = (g.double() - ref).abs()
            ratio = float((d / conv_bound(name, dtype, ref, s)).max())
            err = float(d.max())
            report[name] = {"max_abs": err, "max_over_bound": ratio}
            if ratio > 1.0:
                die(f"{owner[name]} {name} {shape} {dtype}: max |d| {err:.4g} is "
                    f"{ratio:.3g} x the bound")
            errs[owner[name]] = max(errs[owner[name]], err)
            if name == "dw":
                errs["conv3x3_dw_reduce"] = max(errs["conv3x3_dw_reduce"], err)
        print(f"phase 3: conv {list(shape)} {str(dtype)[6:]} {body} bodies: vs float64 plain "
              + json.dumps(report) + "; dW bit-equal in two runs; launches exact")
    print("phase 3: conv kernels match the float64 plain version (fp32: rtol 1e-4 / atol "
          "1e-5 for y and dx, 2e-5 S for dW; bf16: 2^-8 |ref| + 1e-5 S); conv3x3_pack_w "
          "equals the plain version")

    # times, with the settings the main path runs under (torch's defaults:
    # no cuDNN autotuning); the kernels and cuDNN in turns, two rounds.
    # The kernels line takes the wgmma entry points, the reduce and the pack
    # at the flagship's bf16 [128, 64, 64, 64], the ragged ones at phase
    # 12's [128, 64, 48, 48] and the fp32 bodies at the shape phase 6
    # launches them at, each with that shape's bounds
    floor = median_ms(lambda: tc_cuda.launch_empty(dev), reps=11)
    times, bounds = {}, {}
    for shape, dtype in [(sh, bf16) for sh in (*CONV_SHAPES, CONV_WIDE, *CONV_RAGGED_SHAPES)] + \
                        [(sh, fp32) for sh in (*CONV_SHAPES, CONV_FP32_PATH)]:
        x = torch.randn(shape, device=dev, dtype=dtype)
        w = torch.randn((64, 64, 3, 3), device=dev, dtype=dtype) * 0.05
        gy = torch.randn(shape, device=dev, dtype=dtype)
        y = torch.empty_like(x)
        n, _, h, wd = shape
        kind = "fp32" if dtype == fp32 else "bf16"
        launch = conv_cuda.launch
        dw = torch.empty((64, 64, 3, 3), device=dev, dtype=dtype)
        body, n_parts, rc = conv_cuda.dw_parts(shape, dtype, dev)
        part = torch.empty((n_parts, 576, 64), device=dev)
        wp = conv_cuda.conv3x3_pack_w(w)
        if body in ("wgmma", "ragged"):
            fwd, dwk = f"conv3x3_fwd_{body}", f"conv3x3_dw_{body}"
            fns = {
                fwd: lambda: launch(fwd, x, wp, y, n, h, wd, rc, n_parts, device=dev),
                dwk: lambda: launch(dwk, x, gy, part, n, h, wd, rc, n_parts, device=dev),
                "conv3x3_dw_reduce": lambda: launch("conv3x3_dw_reduce", part, dw, n_parts, 1,
                                                    device=dev),
                "conv3x3_pack_w": lambda: conv_cuda.conv3x3_pack_w(w),
                "plain_dw_reduce": lambda: part.sum(0).view(9, 64, 64).permute(
                    2, 1, 0).reshape(64, 64, 3, 3).to(dtype),
                "plain_pack_w": lambda: conv.pack_weights(w, False),
            }
            pair = (dwk, "conv3x3_dw_reduce")
        else:
            fwd = "conv3x3_fwd"
            fns = {
                "conv3x3_fwd": lambda: launch("conv3x3_fwd_fp32", x, wp, y, n, h, wd, n_parts,
                                              device=dev),
                "conv3x3_dw": lambda: launch("conv3x3_dw_fp32", x, gy, part, n, h, wd, n_parts,
                                             device=dev),
                "conv3x3_dw_reduce_fp32": lambda: launch("conv3x3_dw_reduce", part, dw, n_parts,
                                                         0, device=dev),
                "conv3x3_pack_w_fp32": lambda: conv_cuda.conv3x3_pack_w(w),
            }
            pair = ("conv3x3_dw", "conv3x3_dw_reduce_fp32")
        fns.update({
            "cudnn_fwd": lambda: torch.nn.functional.conv2d(x, w, padding=1),
            "cudnn_dgrad": lambda: torch.nn.grad.conv2d_input(shape, w, gy, padding=1),
            "cudnn_wgrad": lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1),
        })
        rounds = [{k: median_ms(f, reps=11) for k, f in order}
                  for order in (list(fns.items()), list(fns.items())[::-1])]
        t = {k: (rounds[0][k] + rounds[1][k]) / 2 for k in fns}
        print(f"phase 3: conv {list(shape)} {kind} median ms per call, mean of two "
              "rounds in turns " + json.dumps({k: round(v, 5) for k, v in t.items()})
              + "; the rounds " + json.dumps({k: [round(r[k], 5) for r in rounds] for k in fns})
              + f"; launch floor {floor:.5f} on {card}")
        b = conv_bounds(shape, kind, n_parts)
        both = t[pair[0]] + t[pair[1]]
        print(f"phase 3: conv {list(shape)} {kind} bounds (each input read once, each output "
              "written once; the fp32 partials between dW and its reduce count in neither) "
              + json.dumps({k: round(v["bound_ms"], 5) for k, v in b.items()})
              + "; share of the bound reached: "
              + json.dumps({fwd: round(b["conv3x3_fwd"]["bound_ms"] / t[fwd], 3),
                            pair[0]: round(b["conv3x3_dw"]["bound_ms"] / t[pair[0]], 3),
                            pair[0] + " + reduce":
                                round(b["conv3x3_dw+reduce"]["bound_ms"] / both, 3)})
              + f"; against cuDNN: {fwd} / cudnn_fwd {t[fwd] / t['cudnn_fwd']:.3f}, "
              f"{fwd} (dx) / cudnn_dgrad {t[fwd] / t['cudnn_dgrad']:.3f}, "
              f"({pair[0]} + reduce) / cudnn_wgrad {both / t['cudnn_wgrad']:.3f}")
        if dtype == fp32:
            # the targets of the fp32 bodies: printed, not enforced
            half = b["conv3x3_fwd"]["bound_ms"] * 2
            met = {"conv3x3_fwd <= cudnn_fwd": t[fwd] <= t["cudnn_fwd"],
                   "conv3x3_fwd (dx) <= cudnn_dgrad": t[fwd] <= t["cudnn_dgrad"],
                   "conv3x3_fwd >= half the bound": t[fwd] <= half,
                   "conv3x3_dw + reduce <= cudnn_wgrad": both <= t["cudnn_wgrad"],
                   "conv3x3_dw + reduce >= half the bound": both <= half}
            print(f"phase 3: conv {list(shape)} fp32 targets (TF32 off): conv3x3_fwd "
                  f"{t[fwd]:.5f} ms = {t[fwd] / t['cudnn_fwd']:.3f} x cuDNN fwd, "
                  f"{t[fwd] / t['cudnn_dgrad']:.3f} x cuDNN dgrad; conv3x3_dw + reduce "
                  f"{both:.5f} ms = {both / t['cudnn_wgrad']:.3f} x cuDNN wgrad; half the bound "
                  f"is {half:.5f} ms; met: " + json.dumps(met))
        if body == "ragged":
            # the aims of the ragged entry points: printed, not enforced
            fill = fill_share(wd)
            met = {"fwd <= cudnn_fwd": t[fwd] <= t["cudnn_fwd"],
                   "dw + reduce <= cudnn_wgrad": both <= t["cudnn_wgrad"]}
            if shape == CONV_48:
                met["fwd >= 0.35 of the bound"] = t[fwd] * 0.35 <= b["conv3x3_fwd"]["bound_ms"]
                met["dw + reduce >= 0.35 of the bound"] = \
                    both * 0.35 <= b["conv3x3_dw+reduce"]["bound_ms"]
            if shape == CONV_NARROW:
                met["fwd <= 3 launch floors"] = t[fwd] <= 3 * floor
                met["dw <= 3 launch floors"] = t[pair[0]] <= 3 * floor
            print(f"phase 3: conv {list(shape)} bf16 ragged aims: fwd {t[fwd]:.5f} ms = "
                  f"{t[fwd] / t['cudnn_fwd']:.3f} x cuDNN fwd, {t[fwd] / floor:.2f} launch "
                  f"floors; dw + reduce {both:.5f} ms = {both / t['cudnn_wgrad']:.3f} x cuDNN "
                  f"wgrad; zero-fill share of the tensor-core work: fwd {fill[0]:.3f}, dw "
                  f"{fill[1]:.3f}; met: " + json.dumps(met))
        if (shape, dtype) in ((CONV_SHAPES[0], bf16), (CONV_48, bf16)):
            for k in (fwd, pair[0]):
                times[k] = {"ms": t[k]}
                bounds[k] = b[k.replace(f"_{body}", "")]
            times[fwd].update(plain_ms=t["cudnn_fwd"], library_ms=t["cudnn_fwd"])
            times[pair[0]].update(plain_ms=t["cudnn_wgrad"], library_ms=t["cudnn_wgrad"])
        if (shape, dtype) == (CONV_SHAPES[0], bf16):
            for k in ("conv3x3_dw_reduce", "conv3x3_pack_w"):
                times[k] = {"ms": t[k]}
                bounds[k] = b[k]
            times["conv3x3_dw_reduce"].update(plain_ms=t["plain_dw_reduce"], library_ms=None)
            times["conv3x3_pack_w"].update(plain_ms=t["plain_pack_w"], library_ms=None)
        if (shape, dtype) == (CONV_FP32_PATH, fp32):
            times["conv3x3_fwd"] = {"ms": t["conv3x3_fwd"], "plain_ms": t["cudnn_fwd"],
                                    "library_ms": t["cudnn_fwd"]}
            times["conv3x3_dw"] = {"ms": t["conv3x3_dw"], "plain_ms": t["cudnn_wgrad"],
                                   "library_ms": t["cudnn_wgrad"]}
            bounds["conv3x3_fwd"], bounds["conv3x3_dw"] = b["conv3x3_fwd"], b["conv3x3_dw"]

    # host time of one wrapper call (enqueue only), at the flagship's shape
    # (wgmma) and phase 12's (ragged)
    host = {}
    for label, shape in (("wgmma", CONV_SHAPES[0]), ("ragged", CONV_48)):
        x = torch.randn(shape, device=dev, dtype=bf16)
        w = torch.randn((64, 64, 3, 3), device=dev, dtype=bf16) * 0.05
        for name, fn in ((f"fwd_{label}", lambda: conv_cuda.conv3x3_fwd(x, w)),
                         (f"dw_{label}", lambda: conv_cuda.conv3x3_dw(x, x))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    print("phase 3: conv wrappers, host microseconds per call (enqueue only; fwd is the pack "
          "and the forward, three tensor maps where TMA lands the rows; dw is the kernel and "
          "the reduce) " + json.dumps({k: round(v, 1) for k, v in host.items()}))
    return {"errs": errs, "times": times, "bounds": bounds, "host_us": host}


BN_CHECKS = [  # (shape, groups, dtype, slope): the flagship's and the 128 px step's calls
    ((128, 64, 64, 64), 2, "bf16", 0.2), ((64, 64, 64, 64), 1, "bf16", 0.2),
    ((128, 128, 32, 32), 2, "bf16", 0.2), ((128, 512, 4, 4), 2, "bf16", 0.2),
    ((64, 512, 4, 4), 1, "bf16", 0.2), ((256, 64, 128, 128), 2, "bf16", 0.2),
    ((128, 64, 64, 64), 2, "bf16", 1.0), ((128, 64, 64, 64), 2, "fp32", 0.2),
    ((128, 512, 4, 4), 2, "fp32", 0.2), ((64, 256, 8, 8), 1, "fp16", 0.2),
    ((6, 10, 5, 3), 2, "bf16", 0.2), ((12, 24, 6, 6), 3, "fp32", 1.0),
]
BN_TIMED = [  # (shape, groups): the largest and the smallest calls of both steps
    ((128, 64, 64, 64), 2), ((64, 64, 64, 64), 1), ((256, 64, 128, 128), 2),
    ((128, 512, 4, 4), 2), ((64, 512, 4, 4), 1),
]
BN_MAIN = (128, 64, 64, 64)
# bn_apply and bn_bwd_dx at >= 0.6 of their bound and bn_stats + bn_finalize
# at >= 0.5 at BN_MAIN; at the 4x4 x 512 shapes each within 3 launch floors
BN_TARGETS = {"apply": 0.6, "bwd_dx": 0.6, "stats+finalize": 0.5, "floors": 3.0}


def bn_bounds(shape, size: int) -> dict:
    """Bounds of the BatchNorm kernels on x ``shape`` of ``size`` bytes an
    element: bn_stats reads x, bn_apply reads x and writes y, bn_bwd_reduce
    reads x and dy, bn_bwd_dx reads x and dy and writes dx; their fp32
    partials and the [G, C] statistics (kilobytes) count in none, and
    bn_finalize's bound is those (under a launch)."""
    act = math.prod(shape) * size
    c = shape[1]
    return {"bn_stats": bound(act, 0, "fp32"), "bn_finalize": bound(32 * c, 0, "fp32"),
            "bn_apply": bound(2 * act, 0, "fp32"), "bn_bwd_reduce": bound(2 * act, 0, "fp32"),
            "bn_bwd_dx": bound(3 * act, 0, "fp32")}


def phase_bn_kernels(card: str) -> dict:
    """Phase 3, BatchNorm: the five kernels (csrc/bn_kernels.cu) through the
    autograd function against the float64 plain version (the tolerances of
    tests/test_torch_bn_cuda.py), twice bit-equal, at ``BN_CHECKS``; then
    at ``BN_TIMED`` in bf16 each kernel's median time in turns beside its
    bound and the launch floor, the whole forward and backward of the
    kernels, of the plain version (the module's stock passes) and of the
    library yardstick ``F.batch_norm`` + ``F.leaky_relu`` (training, the
    batch as one group: the same bytes). Returns per-kernel max_abs_err,
    the times at ``BN_MAIN`` and the bounds there."""
    import torch
    import torch.nn.functional as F

    from intro_tc_vae_tpu_torch.ops import batchnorm as bn, batchnorm_cuda as bc, tc_cuda

    dev = torch.device("cuda", 0)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}
    rounding = {"bf16": 2.0**-8, "fp16": 2.0**-11, "fp32": 0.5e-5}
    errs = dict.fromkeys(bc.KERNELS, 0.0)

    def data(shape, dtype, seed=0):
        g = torch.Generator().manual_seed(seed)
        c = shape[1]
        return ((torch.randn(shape, generator=g) * 1.7 + 0.3).to(dtype).to(dev),
                (torch.rand(c, generator=g) * 0.4 + 0.8).to(dev),
                (torch.rand(c, generator=g) * 0.2 - 0.1).to(dev),
                torch.randn(shape, generator=g).to(dtype).to(dev))

    def fused(x, w, b, dy, groups, slope):
        c = x.shape[1]
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = bc._BatchNormAct.apply(xr, wr, br, (rm, rv), groups, 1e-4, 0.1, slope)
        y.backward(dy)
        return y.detach(), xr.grad, wr.grad, br.grad, rm, rv

    names = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
    worst = {}
    for shape, groups, kind, slope in BN_CHECKS:
        x, w, b, dy = data(shape, dtypes[kind])
        got, again = fused(x, w, b, dy, groups, slope), fused(x, w, b, dy, groups, slope)
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            die(f"bn {shape} g{groups} {kind}: two runs differ")
        f64 = torch.float64
        c = shape[1]
        rm, rv = torch.zeros(c, device=dev, dtype=f64), torch.ones(c, device=dev, dtype=f64)
        want = (bn.batchnorm_act(x.double(), w.double(), b.double(), (rm, rv), groups, 1e-4,
                                 0.1, slope, f64),
                *bn.batchnorm_act_backward_reference(x.double(), dy.double(), w.double(),
                                                     b.double(), groups, 1e-4, slope), rm, rv)
        for name, a, r in zip(names, got, want):
            m, d = float(r.abs().max()), (a.double() - r).abs()
            e = rounding[kind] * (2 if name == "y" and slope != 1.0 else 1)
            if name in ("y", "dx"):
                ok = d <= e * r.abs() + 1e-4 * m
            elif name in ("dweight", "dbias"):
                ok = d <= 1e-3 * (r.abs() + m)
            else:
                ok = d <= 1e-5 * r.abs()
            if not bool(ok.all()):
                die(f"bn {shape} g{groups} {kind} slope {slope}: {name} max |d| "
                    f"{float(d.max()):.3g} (max |ref| {m:.3g})")
            worst[name] = max(worst.get(name, 0.0), float(d.max()))
            if kind == "bf16" and shape == BN_MAIN and slope != 1.0:
                # each kernel's error: that of the output it decides
                for k in {"y": ("bn_apply",), "dx": ("bn_bwd_dx",),
                          "dweight": ("bn_bwd_reduce",),
                          "running_mean": ("bn_stats", "bn_finalize")}.get(name, ()):
                    errs[k] = float(d.max())
    print("phase 3: bn kernels match the float64 plain version at "
          + json.dumps([[list(s), g, k, sl] for s, g, k, sl in BN_CHECKS])
          + " (y, dx: e |ref| + 1e-4 max|ref|, e the dtype's roundings; dweight, dbias 1e-3; "
          "running statistics rtol 1e-5), two runs bit-equal; max |d| "
          + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))

    floor = median_ms(lambda: tc_cuda.launch_empty(dev), reps=11)
    times, bounds = {}, {}
    for shape, groups in BN_TIMED:
        x, w, b, dy = data(shape, torch.bfloat16)
        n, c = shape[:2]
        hw = math.prod(shape[2:])
        plan = bn.launch_plan(n, c, hw, groups, 2, bc.sm_count(dev))
        sh = (n, c, hw, groups, plan.slices, plan.samples, plan.vector, plan.threads)
        part = torch.empty((groups * c * plan.slices, 2), device=dev)
        stat = torch.empty((groups, c, 4), device=dev)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        dw, db = torch.empty(c, device=dev), torch.empty(c, device=dev)
        count = n // groups * hw
        bc.launch("bn_stats", x, part, *sh, 1, device=dev)
        bc.launch("bn_finalize", part, w, stat, rm, rv, c, groups, plan.slices, count, 1e-4,
                  0.9, 0.1, device=dev)
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        paths = {}
        for label, fn in (("kernels", lambda a, p, q: bc._BatchNormAct.apply(
                                a, p, q, None, groups, 1e-4, 0.1, 0.2)),
                          ("plain", lambda a, p, q: bn.batchnorm_act(
                              a, p, q, None, groups, 1e-4, 0.1, 0.2, torch.bfloat16)),
                          ("library", lambda a, p, q: F.leaky_relu(F.batch_norm(
                              a, None, None, p, q, True, 0.1, 1e-4), 0.2))):
            out = fn(xr, wr, br)
            paths[f"{label}_fwd"] = lambda fn=fn: fn(xr, wr, br)
            paths[f"{label}_bwd"] = lambda out=out: torch.autograd.grad(
                out, (xr, wr, br), dy, retain_graph=True)
        fns = {
            "bn_stats": lambda: bc.launch("bn_stats", x, part, *sh, 1, device=dev),
            "bn_finalize": lambda: bc.launch("bn_finalize", part, w, stat, None, None, c, groups,
                                             plan.slices, count, 1e-4, 0.9, 0.1, device=dev),
            "bn_apply": lambda: bc.launch("bn_apply", x, stat, b, y, *sh, 0.2, 1, device=dev),
            "bn_bwd_reduce": lambda: bc.launch("bn_bwd_reduce", x, dy, stat, b, part, *sh, 0.2,
                                               1, device=dev),
            "bn_bwd_dx": lambda: bc.launch("bn_bwd_dx", x, dy, stat, b, part, dx, dw, db, *sh,
                                           0.2, 1, device=dev),
            **paths,
        }
        rounds = [{k: median_ms(f, reps=11) for k, f in order}
                  for order in (list(fns.items()), list(fns.items())[::-1])]
        t = {k: (rounds[0][k] + rounds[1][k]) / 2 for k in fns}
        bd = bn_bounds(shape, 2)
        share = {k: bd[k]["bound_ms"] / t[k] for k in bc.KERNELS}
        share["stats+finalize"] = bd["bn_stats"]["bound_ms"] / (t["bn_stats"] + t["bn_finalize"])
        print(f"phase 3: bn {list(shape)} groups {groups} bf16 {plan}; median ms per call, mean "
              "of two rounds in turns " + json.dumps({k: round(v, 5) for k, v in t.items()})
              + "; bounds " + json.dumps({k: round(v["bound_ms"], 5) for k, v in bd.items()})
              + "; share of the bound " + json.dumps({k: round(v, 3) for k, v in share.items()})
              + "; launch floors " + json.dumps({k: round(t[k] / floor, 2) for k in bc.KERNELS})
              + f" (floor {floor:.5f} ms) on {card}")
        if shape == BN_MAIN:
            met = {f"{k} >= {v} of the bound": share[k if k == "stats+finalize" else f"bn_{k}"]
                   >= v for k, v in BN_TARGETS.items() if k != "floors"}
        elif shape[2] == 4:
            met = {f"{k} <= {BN_TARGETS['floors']} launch floors":
                   t[k] <= BN_TARGETS["floors"] * floor for k in bc.KERNELS}
        else:
            met = None
        if met is not None:
            print(f"phase 3: bn {list(shape)} groups {groups} targets (printed, not enforced): "
                  + json.dumps(met))
        if shape == BN_MAIN:
            for k in bc.KERNELS:
                side = "fwd" if k in ("bn_stats", "bn_finalize", "bn_apply") else "bwd"
                times[k] = {"ms": t[k], "plain_ms": t[f"plain_{side}"],
                            "library_ms": t[f"library_{side}"]}
                bounds[k] = bd[k]
    return {"errs": errs, "times": times, "bounds": bounds}


def bn_calls_128(card: str) -> None:
    """Phase 4 (bn): the 128 px recipe (batch 128) with tc and conv
    'pallas' through ``bench.build_solver``, graphed by the trainer's rule,
    7 steps (3 eager, the capture, 3 replays): every train-mode BatchNorm
    call goes through the kernels, 81 a step (the flagship's 67 are phase
    4's exact counts), none takes the plain route; an eval-mode decode
    launches no BatchNorm kernel."""
    import torch

    from intro_tc_vae_tpu_torch import bench
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda as bc

    batch, steps = 128, 7
    enc, dec = bn_layers(channels=tuple(bench.CHANNELS[128]))
    want = bn_launches(3 * enc + 4 * dec)  # three encoder and four decoder calls a step
    solver, state, x = bench.build_solver(
        "intro_tc", batch, 128, "cuda", conv_impl="pallas", **bench.BETAS,
        tc_impl="pallas", fuse_passes=True, test_iter=10**9)
    bc.reset_launch_counts()
    for _ in range(steps):
        solver.train_step(state, x)
    solver.drain_metrics(0)
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    if launches != {k: steps * v for k, v in want.items()} or any(bc.CALLS.values()):
        die(f"bn at 128 px: launches {launches}, calls {dict(bc.CALLS)} in {steps} steps, "
            f"expected {want} a step and no plain call")
    with torch.no_grad():
        state.model.eval()
        state.model.decoder(torch.randn(batch, bench.ZDIM, device=x.device))
        torch.cuda.synchronize()
    if dict(bc.LAUNCHES) != launches:
        die("bn at 128 px: an eval-mode decode launched BatchNorm kernels")
    print(f"phase 4 (bn): 128 px batch {batch}: {want['bn_stats']} BatchNorm calls a step "
          f"through the kernels, launches a step " + json.dumps(want)
          + f", no plain call; an eval decode launches none on {card}")
    del solver, state, x
    torch.cuda.empty_cache()


def bn_layers(arch: str = "conv", channels: tuple = (64, 128, 256, 512)) -> tuple:
    """(encoder, decoder) GroupedBatchNorm layers of an ``arch`` model with
    ``channels`` (the 64 px datasets' by default): a pass calls each once.
    conv and res at 64 px: (9, 10), the stem and two a block of the
    encoder's four blocks, two a block of the decoder's five; inception
    three a block."""
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, GroupedBatchNorm

    kw = dict(arch=arch, cdim=3, zdim=8, channels=channels, image_size=2 ** len(channels))
    return tuple(sum(isinstance(m, GroupedBatchNorm) for m in net(**kw).modules())
                 for net in (Encoder, Decoder))


def bn_launches(calls: int, recomputed: int = 0) -> dict:
    """batchnorm_cuda.LAUNCHES after ``calls`` differentiated train-mode
    BatchNorm calls, ``recomputed`` of them run again in the backward
    (remat): a call launches the forward's three kernels and the
    backward's two once each, a recompute the forward's once more."""
    fwd = calls + recomputed
    return {"bn_stats": fwd, "bn_finalize": fwd, "bn_apply": fwd, "bn_bwd_reduce": calls,
            "bn_bwd_dx": calls}


def all_launches() -> dict:
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, conv_cuda, tc_cuda

    return {**tc_cuda.LAUNCHES, **conv_cuda.LAUNCHES, **batchnorm_cuda.LAUNCHES}


def reset_all_launches() -> None:
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, conv_cuda, tc_cuda

    tc_cuda.reset_launch_counts()
    conv_cuda.reset_launch_counts()
    batchnorm_cuda.reset_launch_counts()


def expected_intro_launches(tc_impl: str, conv_impl: str, remat=False, routed: int = 3,
                            body: str = "wgmma", bn: tuple | None = None) -> tuple:
    """Launches in phase E and in phase D of one paired flagship step,
    derived from the pass list of solvers/intro.py.

    TC: one call per KL term: real, rec, fake in phase E, rec, fake in
    phase D; each call's loss is differentiated, so each launches tc_fwd,
    tc_bwd_dz and tc_bwd_dmu once: 3 and 2.
    Conv: the decoder routes ``routed`` convs (3 at 64 px: res_in_32.conv2,
    res_in_64.conv1, .conv2; 2 at 48 px: res_in_48.conv1, .conv2); the
    encoder none. Each phase makes 2 paired decoder calls. Every routed
    conv calls conv3x3_fwd for its forward ('pallas' only) and for its dx
    (both: its input depends on the decoder's fc weights or on z).
    conv3x3_dw with conv3x3_dw_reduce is called once per routed conv of the
    network the phase updates: 0 in phase E (the decoder is frozen), 2
    calls x 3 = 6 in phase D at 64 px. The flagship is bf16 and its routed
    shapes take one bf16 body, ``body``: at 64 px ([128, 64, 64, 64],
    [128, 64, 32, 32]) the wgmma entry points, at 48 px ([128, 64, 48, 48])
    the ragged ones; no fp32 body (conv3x3_fwd, conv3x3_dw) launches, and
    every forward packs its weights first: conv3x3_pack_w as often.
    ``remat`` ("block" or "pass"; the two recompute the same convs): every
    decoder call is differentiated, so its backward recomputes each routed
    conv's forward once more, a kernel launch under 'pallas' (the stock
    forward under 'hybrid'); the TC calls lie outside the recomputed
    regions (tests/test_torch_solver_surface.py counts the same on the
    CPU).
    BatchNorm: ``bn`` (encoder, decoder) layers (``bn_layers()``, the
    flagship's, when None; (0, 0) where a data group takes the plain
    version). Phase E calls the encoder twice (the batch, then rec and
    fake paired) and the decoder twice, phase D the encoder once and the
    decoder twice, every call differentiated: 2 x 9 + 2 x 10 = 38 and 9 +
    2 x 10 = 29 calls at 64 px, 67 a step. ``remat`` "pass" recomputes
    every call once more, "block" every call but the encoder's stem, which
    lies outside its blocks."""
    tc = 1 if tc_impl == "pallas" else 0
    enc, dec = bn_layers() if bn is None else bn
    redo = {False: 0, "block": enc - 1, "pass": enc}[remat] if enc else 0
    fwd_per_conv = {"pallas": 2 + bool(remat), "hybrid": 1, "xla": 0}[conv_impl]
    dw = 2 * routed if conv_impl != "xla" else 0

    def counts(tc_calls, fwd, dws, encodes):
        calls = encodes * enc + 2 * dec
        return {**conv_launches(fwd, dws, body), "tc_fwd": tc_calls * tc,
                "tc_bwd_dz": tc_calls * tc, "tc_bwd_dmu": tc_calls * tc,
                **bn_launches(calls, encodes * redo + 2 * dec if remat else 0)}

    per_phase = 2 * routed * fwd_per_conv
    return counts(3, per_phase, 0, 2), counts(2, per_phase, dw, 1)


def conv_launches(fwd: int, dw: int, body: str) -> dict:
    """conv_cuda.LAUNCHES after ``fwd`` conv3x3_fwd and ``dw`` conv3x3_dw
    calls of one body (``conv.kernel_body``): every forward packs its
    weights first, every dW is reduced; the fp32 bodies count under the
    wrappers' own names."""
    from intro_tc_vae_tpu_torch.ops import conv_cuda

    suffix = "" if body == "fp32" else f"_{body}"
    return {**dict.fromkeys(conv_cuda.KERNELS, 0), f"conv3x3_fwd{suffix}": fwd,
            "conv3x3_pack_w": fwd, f"conv3x3_dw{suffix}": dw, "conv3x3_dw_reduce": dw}


@contextlib.contextmanager
def launches_per_phase(read=all_launches):
    """Sums the launches (or what ``read`` counts) of phase E and of phase
    D over the steps of an intro run: each step updates the encoder at the
    end of phase E and the decoder at the end of phase D; a hook at each
    update (``launch_counts.on_mark``, which a graph's replay runs between
    its tally's segments as an eager step runs it) reads the counters."""
    from intro_tc_vae_tpu_torch.ops import launch_counts

    sums = [dict.fromkeys(read(), 0), dict.fromkeys(read(), 0)]
    state = {"last": read(), "calls": 0}

    def hook():
        now = read()
        phase = sums[state["calls"] % 2]
        for k in now:
            phase[k] += now[k] - state["last"][k]
        state["last"], state["calls"] = now, state["calls"] + 1

    handle = launch_counts.on_mark(hook)
    try:
        yield sums
    finally:
        handle.remove()


def run_cli(config: str, update: dict, name: str, steps: int = 20):
    """``steps`` steps through the CLI; checks the step count and that every
    recorded value is finite; returns the final TrainState. The run's
    checkpoints go to a temporary directory, deleted afterwards, unless
    ``update`` names a ``checkpoint_dir``."""
    import shutil
    import tempfile

    from intro_tc_vae_tpu_torch import main

    work = None
    if "checkpoint_dir" not in update:
        work = tempfile.mkdtemp(prefix="chip_smoke_saves_")
        update = {**update, "checkpoint_dir": work}
    try:
        state = main.cli(["-f", config, "-u", json.dumps(update)])
    finally:
        if work is not None:
            shutil.rmtree(work)
    if len(state.history) != steps:
        die(f"{name}: {len(state.history)} steps, expected {steps}")
    for rec in state.history:
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                die(f"{name}: non-finite {k} at step {rec['step']}")
    return state


# The eval-mode decode of one batch of noise after a run's last epoch
# (train.py): the three routed decoder convs forward, no backward, in the
# wgmma bodies for bf16 and the fp32 bodies for fp32; 'hybrid' and 'xla'
# run the stock forward
def final_decode_launches(conv_impl: str, fp32: bool = False) -> dict:
    n = 3 if conv_impl == "pallas" else 0
    fwd = "conv3x3_fwd" if fp32 else "conv3x3_fwd_wgmma"
    return {fwd: n, "conv3x3_pack_w": n}


INTRO_ARMS = (("pallas", "xla"), ("xla", "xla"), ("pallas", "pallas"), ("pallas", "hybrid"))


def phase_main_path(card: str) -> dict:
    """Phase 4: the CLI trains 20 flagship steps in each of INTRO_ARMS."""
    from intro_tc_vae_tpu_torch.train import images_per_second

    rates, launches = {}, {}
    for tc_impl, conv_impl in INTRO_ARMS:
        arm = f"tc {tc_impl}, conv {conv_impl}"
        update = {"dataset": "synthetic", "tc_impl": tc_impl, "conv_impl": conv_impl,
                  "num_epochs": 1, "use_tensorboard": False}
        reset_all_launches()
        with launches_per_phase() as (phase_e, phase_d):
            state = run_cli(FLAGSHIP, update, arm)
        counts = all_launches()
        want_e, want_d = expected_intro_launches(tc_impl, conv_impl)
        tail = final_decode_launches(conv_impl)
        for label, got, want in (("phase E", phase_e, {k: 20 * v for k, v in want_e.items()}),
                                 ("phase D", phase_d, {k: 20 * v for k, v in want_d.items()}),
                                 ("total", counts,
                                  {k: 20 * (want_e[k] + want_d[k]) + tail.get(k, 0)
                                   for k in want_e})):
            if got != want:
                die(f"{arm}: {label} launches {got}, expected {want}")
        rates[arm] = images_per_second(state, MAIN_B)
        launches[arm] = counts
        last = state.history[-1]
        print(f"phase 4: {arm}: 20 steps, finite losses (last lossE {last['lossE']:.6g} "
              f"lossD {last['lossD']:.6g}); launches phase E {phase_e}, phase D {phase_d}")
    print("phase 4: img/s (steps 5-20, bf16, batch 64) "
          + json.dumps({k: round(v, 1) for k, v in rates.items()}) + f" on {card}")
    return {"rates": rates, "launches": launches["tc pallas, conv pallas"]}


@contextlib.contextmanager
def plain_batchnorm():
    """Train-mode BatchNorm takes its plain version (``ops/batchnorm.py``)
    on the card, for the float64 references: its kernels take float32,
    bfloat16 and float16 only, as the conv and TC kernels do, whose plain
    versions conv_impl and tc_impl 'xla' pick. A data group's calls go on
    as the program routes them."""
    from intro_tc_vae_tpu_torch.models import blocks
    from intro_tc_vae_tpu_torch.ops import batchnorm as bn

    routed = blocks.batchnorm_act_train

    def plain(x, weight, bias, running, groups, eps, momentum, slope, out_dtype,
              data_group=None):
        if data_group is not None:
            return routed(x, weight, bias, running, groups, eps, momentum, slope, out_dtype,
                          data_group)
        return bn.batchnorm_act(x, weight, bias, running, groups, eps, momentum, slope,
                                out_dtype)

    blocks.batchnorm_act_train = plain
    try:
        yield
    finally:
        blocks.batchnorm_act_train = routed


@contextlib.contextmanager
def plain_tc_in_float64():
    """tc_impl 'xla' evaluates the plain TC version in float64 on the same
    float32 inputs and returns float32, as phase 3 holds the kernels to it."""
    import torch

    from intro_tc_vae_tpu_torch.ops import tc

    plain = tc.tc_logsumexp_reference

    def plain64(z, mu, logvar, dataset_size):
        pm, qz = plain(z.double(), mu.double(), logvar.double(), dataset_size)
        return pm.float(), qz.float()

    tc.tc_logsumexp_reference = plain64
    try:
        yield
    finally:
        tc.tc_logsumexp_reference = plain


def train_one_step(dev, cfg, ds, kw: dict, init: dict, batch, noise: dict, impl: str,
              conv_impl: str = "xla", options: dict | None = None):
    """One intro_tc step of the model ``kw`` from the weights ``init`` on
    ``batch`` with ``noise``, tc_impl ``impl``, the model ``options``
    (``tile_rows`` for both networks, ``pack_predict`` for the decoder):
    (metrics, state dict) on the host. Phases 5, 11 (a) and 13 in fp32,
    phase 12 in bf16."""
    import torch

    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    options = options or {}
    enc_options = {k: v for k, v in options.items() if k != "pack_predict"}
    model = SoftIntroVAE(Encoder(**kw, conv_impl=conv_impl, **enc_options),
                         Decoder(**kw, conv_impl=conv_impl, **options))
    model.load_state_dict(init)
    model.to(dev)
    solver = make_solver(
        "intro_tc", dataset=ds, encoder=model.encoder, decoder=model.decoder,
        batch_size=MAIN_B, optimizer_e=make_optimizer("adam", cfg.lr),
        optimizer_d=make_optimizer("adam", cfg.lr),
        recon_loss_type=cfg.recon_loss_type, beta_kl=cfg.beta_kl,
        beta_rec=cfg.beta_rec, beta_neg=cfg.beta_neg, gamma_r=cfg.gamma_r,
        tc_impl=impl, fuse_passes=True)
    state = solver.init_state(0)
    state, metrics = solver.train_step(state, batch.to(dev), noise=noise)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})


def params_diff(p_a: dict, p_b: dict) -> tuple:
    """(largest absolute difference, entries over ATOL) of two state dicts."""
    import numpy as np

    worst = max(float(np.abs(p_a[k] - p_b[k]).max()) for k in p_b)
    n_over = sum(int((np.abs(p_a[k] - p_b[k]) > ATOL).sum()) for k in p_b)
    return worst, n_over


def phase_in_context(dev) -> None:
    """Phase 5: one fp32 step with the kernels vs one with the plain
    versions, from the same weights, batch and noise: (a) the TC kernels,
    (b) the conv kernels; (c) the flagship decoder alone.

    (a) TC by the kernels vs by the plain version.

    The plain version runs in float64 inside the step (its inputs and
    outputs stay float32): in float32 its softmax weights exp(iw + sum_l P
    - lj), with |sum_l P| in the thousands, carry ~1e-4 of rounding, which
    reaches the parameter gradients, and Adam's first update, about
    lr * sign(g), turns it into whole-update differences (up to 2 * lr) on
    entries whose gradient is near 0. The float32 plain step's difference
    is printed too.
    """
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS

    cfg = load_config(FLAGSHIP, {"dataset": "synthetic", "precision": "fp32"})
    ds, image_size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=channels,
              image_size=image_size, compute_dtype=torch.float32)
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).state_dict()
    batch = torch.from_numpy(ds.get_batch(np.arange(MAIN_B)).transpose(0, 3, 1, 2).copy())
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = {k: torch.randn((MAIN_B, cfg.z_dim), generator=gen, device=dev)
             for k in NOISE_KEYS}
    def one_step(impl: str, conv_impl: str = "xla"):
        return train_one_step(dev, cfg, ds, kw, init, batch, noise, impl, conv_impl)

    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    m_k, p_k = one_step("pallas")
    with plain_tc_in_float64():
        m_x, p_x = one_step("xla")
    m_32, p_32 = one_step("xla")

    n_params = sum(v.size for v in p_x.values())
    worst32, over32 = params_diff(p_32, p_x)
    print(f"phase 5: float32 plain TC step vs float64 plain TC step: metrics max rel "
          f"{max(abs(m_32[n] - m_x[n]) / abs(m_x[n]) for n in names):.3g}; updated "
          f"params max abs diff {worst32:.3g}, {over32} of {n_params} entries over {ATOL}")
    for name in names:
        if not math.isclose(m_k[name], m_x[name], rel_tol=RTOL, abs_tol=1e-30):
            die(f"phase 5: {name} pallas {m_k[name]!r} vs xla {m_x[name]!r}")
    worst, n_over = params_diff(p_k, p_x)
    print(f"phase 5: kernel step vs float64 plain TC step: updated params max abs "
          f"diff {worst:.3g}, {n_over} of {n_params} entries over {ATOL}")
    for k in p_x:
        np.testing.assert_allclose(p_k[k], p_x[k], rtol=0, atol=ATOL, err_msg=f"phase 5: {k}")
    print("phase 5: one fp32 step (TF32 off), pallas vs xla: metrics within rtol 1e-4 "
          + json.dumps({n: [m_k[n], m_x[n]] for n in names})
          + f"; updated params max abs diff {worst:.3g} (atol 1e-5)")

    # (b) the conv kernels in the step: both steps run the TC kernels
    m_c, p_c = one_step("pallas", conv_impl="pallas")
    for name in names:
        if not math.isclose(m_c[name], m_k[name], rel_tol=RTOL, abs_tol=1e-30):
            die(f"phase 5: conv pallas {name} {m_c[name]!r} vs conv xla {m_k[name]!r}")
    worst, n_over = params_diff(p_c, p_k)
    if not worst <= 2 * LR:
        die(f"phase 5: conv pallas vs xla: updated params differ by {worst!r} > 2 lr")
    print("phase 5: one fp32 step (TF32 off), conv_impl pallas vs xla: metrics within "
          "rtol 1e-4 " + json.dumps({n: [m_c[n], m_k[n]] for n in names})
          + f"; updated params max abs diff {worst:.3g} (<= 2 lr = {2 * LR:g}), "
          f"{n_over} of {n_params} entries over {ATOL}")

    # (c) the flagship decoder alone, at the paired shape of the main path
    phase_decoder(dev, kw, {k: v for k, v in init.items() if k.startswith("decoder.")})


def phase_decoder(dev, kw: dict, init: dict) -> None:
    """Phase 5 (c): the flagship decoder's forward and backward in fp32,
    conv_impl 'pallas' and 'xla' (cuDNN, TF32 off), each against the
    float64 decoder (cuDNN in float64, ``plain_batchnorm``), same weights and z [128, 128] as
    two groups of 64 (a paired call), in train and in eval mode; the
    gradients are those of sum(y * c), c ~ N(0, 1).

    Tolerances: the output within 1e-5 of float64 (sigmoid values in
    [0, 1]); each parameter gradient's max |d| to float64 at most 2x the
    stock fp32 decoder's plus 1e-4 of the tensor's largest entry. The two
    fp32 decoders are not held to each other: through five blocks of
    LeakyReLU kinks and, in train mode, BatchNorm's fp32 variance
    E[x^2] - E[x]^2, which cancels, both land some 1e-2 of the largest
    entry away from float64 in their deepest gradients (res_in_8.conv1,
    the fc), and as far from each other (on an H100 80GB HBM3 the direct
    comparison failed at 12-18x a 1e-3 / 1e-4 bound)."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.models import Decoder

    gen = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn((2 * MAIN_B, kw["zdim"]), generator=gen, device=dev)
    cot = torch.randn((2 * MAIN_B, kw["cdim"], kw["image_size"], kw["image_size"]),
                      generator=gen, device=dev)

    def run(conv_impl, train, dtype=torch.float32):
        dec = Decoder(**{**kw, "compute_dtype": dtype}, conv_impl=conv_impl)
        dec.load_state_dict({k[len("decoder."):]: v for k, v in init.items()})
        dec.to(dev).to(dtype).train(train)
        with plain_batchnorm() if dtype == torch.float64 else contextlib.nullcontext():
            y = dec(z.to(dtype), groups=2)
            names, params = zip(*dec.named_parameters())
            grads = torch.autograd.grad((y.to(dtype) * cot.to(dtype)).sum(), params)
        torch.cuda.synchronize()
        return (y.detach().double().cpu().numpy(),
                {n: g.double().cpu().numpy() for n, g in zip(names, grads)})

    for mode, train in (("train", True), ("eval", False)):
        (y_k, g_k), (y_x, g_x) = run("pallas", train), run("xla", train)
        y_64, g_64 = run("xla", train, torch.float64)
        dy_k, dy_x = float(np.abs(y_k - y_64).max()), float(np.abs(y_x - y_64).max())
        if not dy_k <= 1e-5:
            die(f"phase 5: {mode} decoder output pallas vs float64 differs by {dy_k!r}")
        rel = {}
        for n, ref in g_64.items():
            scale = float(np.abs(ref).max())
            d_k = float(np.abs(g_k[n] - ref).max())
            d_x = float(np.abs(g_x[n] - ref).max())
            if not d_k <= 2 * d_x + 1e-4 * scale:
                die(f"phase 5: {mode} decoder grad {n}: |pallas - f64| {d_k:.4g} > 2 x "
                    f"|xla - f64| {d_x:.4g} + 1e-4 x {scale:.4g}")
            rel[n] = (d_k / scale, d_x / scale)
        top = sorted(rel.items(), key=lambda kv: -kv[1][0])[:3]
        print(f"phase 5: decoder fwd+bwd fp32, {mode} mode, vs float64: output max abs "
              f"diff pallas {dy_k:.3g}, xla {dy_x:.3g} (<= 1e-5); {len(rel)} gradients "
              f"within 2x xla's distance + 1e-4 max|g|; largest max|d|/max|g| "
              "(pallas, xla): " + json.dumps({n: [round(a, 6), round(b, 6)]
                                             for n, (a, b) in top}))


def phase_other_paths(card: str) -> dict:
    """Phase 6: vae_synthetic.json and tc_dsprites.json (synthetic data)
    through the CLI, 20 steps each with conv_impl 'pallas' and 'xla'.

    Derived per step (one forward, both networks differentiated): the
    decoder routes the same 3 convs as the flagship's (the res arch's
    res_in_32 and res_in_64 have the conv arch's 3x3 convs), each launching
    conv3x3_fwd for its forward and for its dx, and conv3x3_dw and
    conv3x3_dw_reduce once: 6, 3, 3. tc: one TC call, differentiated: 1 of
    each TC kernel. Both run in fp32, so every conv launch is an fp32 body
    (no wgmma body), and every conv3x3_fwd packs its weights first:
    conv3x3_pack_w 6. The runs go through the CLI; the trainer turns TF32
    off for ``precision: "fp32"``, so at every optimizer call both switches
    must be off: cuDNN's convs of the 'xla' arm are true fp32 like the
    routed ones of the 'pallas' arm. Returns the launches of the
    vae_synthetic run."""
    from intro_tc_vae_tpu_torch.train import images_per_second

    rates, vae_launches = {}, {}
    for label, config, update, tc, arch in (
            ("vae_synthetic (res, vae)", VAE_SYNTHETIC, {}, 0, "res"),
            ("tc_dsprites (conv, tc)", TC_DSPRITES,
             {"dataset": "synthetic", "tc_impl": "pallas", "use_tensorboard": False}, 1,
             "conv")):
        for conv_impl in ("pallas", "xla"):
            run = f"{label}, conv {conv_impl}"
            k = 1 if conv_impl == "pallas" else 0
            tail = final_decode_launches(conv_impl, fp32=True)
            want = {**conv_launches(20 * 6 * k + tail["conv3x3_fwd"], 20 * 3 * k, "fp32"),
                    "tc_fwd": 20 * tc, "tc_bwd_dz": 20 * tc, "tc_bwd_dmu": 20 * tc,
                    **bn_launches(20 * sum(bn_layers(arch)))}
            reset_all_launches()
            with tf32_at_optimizer_calls() as tf32:
                state = run_cli(config, {**update, "conv_impl": conv_impl, "num_epochs": 1},
                                run)
            counts = all_launches()
            if counts != want:
                die(f"{run}: launches {counts}, expected {want}")
            if tf32 != {(False, False)}:
                die(f"{run}: an fp32 run stepped with (cudnn.allow_tf32, cuda.matmul."
                    f"allow_tf32) = {sorted(tf32)}, expected both off")
            if config == VAE_SYNTHETIC and conv_impl == "pallas":
                vae_launches = counts
            rates[run] = images_per_second(state, MAIN_B)
            print(f"phase 6: {run}: 20 steps, finite losses (last loss "
                  f"{state.history[-1]['loss_enc']:.6g}), launches {counts}")
    print(f"phase 6: TF32 off at every optimizer call of the four runs; outside them "
          f"(cudnn.allow_tf32, cuda.matmul.allow_tf32) = {tf32_flags()}")
    print("phase 6: img/s (steps 5-20, fp32 with TF32 off, batch 64) "
          + json.dumps({k: round(v, 1) for k, v in rates.items()}) + f" on {card}")
    return vae_launches


DP_UPDATE = {"dataset": "synthetic128", "data_parallel": DP_RANKS, "tc_impl": "pallas",
             "num_epochs": 1, "use_tensorboard": False, "resume": None}


def dp_step_setup(dev, config: str = DP_CONFIG, update: dict = DP_UPDATE, f64: bool = False):
    """The inputs of phase 7 (b)'s and phase 14 (c)'s gate step, made alike
    in every process: ``config``'s models (with ``update``) in fp32 (with
    ``f64``: in float64, conv_impl 'xla' and, in ``dp_step``, BatchNorm's
    plain version, the kernels taking fp32 and bf16 only) from torch.manual_seed(0), the first global batch of its
    dataset and the step's noise at the global batch (CPU generator, seed
    1). Returns (config, dataset, models, batch, noise)."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import (
        Decoder,
        Encoder,
        SoftIntroVAE,
        resolve_conv_impl,
    )
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS

    cfg = load_config(config, {**update, "precision": "fp32"})
    ds, image_size, channels, cdim = load_dataset(cfg.dataset)
    dtype = torch.float64 if f64 else torch.float32
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=channels,
              image_size=image_size, compute_dtype=dtype,
              conv_impl="xla" if f64 else resolve_conv_impl(cfg.conv_impl))
    torch.manual_seed(0)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev, dtype)
    batch = torch.from_numpy(ds.get_batch(np.arange(cfg.batch_size))
                             .transpose(0, 3, 1, 2).copy()).to(dtype)
    gen = torch.Generator().manual_seed(1)
    noise = {k: torch.randn((cfg.batch_size, cfg.z_dim), generator=gen).to(dev, dtype)
             for k in NOISE_KEYS}
    return cfg, ds, model, batch, noise


def dp_step(dev, mesh=None, config: str = DP_CONFIG, update: dict = DP_UPDATE,
            f64: bool = False):
    """One fp32 intro_tc step (TF32 off, tc_impl 'pallas'; with ``f64`` a
    float64 step, tc_impl 'xla') of ``config`` from dp_step_setup's
    inputs; ``mesh``: this rank's place in the mesh, which steps on its
    data index's rows of the batch, with its slices of the state under a
    model axis. Returns (metrics, the whole state dict on the host)."""
    import torch

    from intro_tc_vae_tpu_torch.parallel import (
        batch_sharding,
        gather_state,
        replicate_state,
        shard_state,
    )
    from intro_tc_vae_tpu_torch.solvers import make_optimizer, make_solver

    cfg, ds, model, batch, noise = dp_step_setup(dev, config, update, f64)
    rows = slice(None) if mesh is None else batch_sharding(mesh, cfg.batch_size)
    solver = make_solver(
        "intro_tc", dataset=ds, encoder=model.encoder, decoder=model.decoder,
        batch_size=cfg.batch_size, optimizer_e=make_optimizer("adam", cfg.lr),
        optimizer_d=make_optimizer("adam", cfg.lr), recon_loss_type=cfg.recon_loss_type,
        beta_kl=cfg.beta_kl, beta_rec=cfg.beta_rec, beta_neg=cfg.beta_neg,
        gamma_r=cfg.gamma_r, tc_impl="xla" if f64 else "pallas", fuse_passes=True,
        mesh=mesh)
    state = solver.init_state(0)
    if mesh is not None:
        state = shard_state(replicate_state(state, mesh), mesh)
    with fp32_exact(), plain_batchnorm() if f64 else contextlib.nullcontext():
        state, metrics = solver.train_step(state, batch[rows].to(dev), noise=noise)
        torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu() for k, v in gather_state(model).items()})


def dp_rank(out_path: str) -> None:
    """One rank of phase 7, started by phase_data_parallel with RANK,
    WORLD_SIZE, LOCAL_RANK and ITCVAE_COORDINATOR_ADDRESS set: (a) trains
    one epoch of the dp8 config through the CLI's entry, with every count
    set to 0 just before and read per phase; (b) one fp32 step on its
    rows. Writes its results to ``out_path`` (torch.save)."""
    import torch
    import torch.distributed as dist

    from intro_tc_vae_tpu_torch import main as cli_main
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.ops import tc_cuda
    from intro_tc_vae_tpu_torch.parallel import make_mesh, state_digest
    from intro_tc_vae_tpu_torch.train import images_per_second

    def counts():
        return {**all_launches(), **{f"calls.{k}": v for k, v in tc_cuda.CALLS.items()}}

    # the final checkpoint (rank 0 writes) beside the results, for (g)
    update = {**DP_UPDATE, "checkpoint_dir": os.path.join(os.path.dirname(out_path), "saves")}
    reset_all_launches()
    with launches_per_phase(counts) as (phase_e, phase_d):
        state = cli_main.cli(["-f", DP_CONFIG, "-u", json.dumps(update)])
    train = dict(history=state.history, counts=counts(), phase_e=phase_e,
                 phase_d=phase_d, digest=state_digest(state.model),
                 rate=images_per_second(state, load_config(DP_CONFIG, DP_UPDATE).batch_size),
                 backend=dist.get_backend(), device=str(next(state.model.parameters()).device))
    del state
    torch.cuda.empty_cache()
    mesh = make_mesh()
    metrics, params = dp_step(mesh.device, mesh)
    torch.save(dict(train=train, metrics=metrics, params=params), out_path)


def start_ranks(phase: str, n: int, args: list, work: str) -> tuple:
    """``n`` processes of this script (``args``: its rank flag and any
    more arguments, then each rank's result path), started as a user
    starts ranks (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and the
    coordinator's address; all on this card), under one DP_TIMEOUT; a
    rank that fails fails the phase, with its log's end on stderr, and
    the others are killed. Returns (each rank's result, rank 0's log)."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), ITCVAE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        logs.append(open(os.path.join(work, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args,
             os.path.join(work, f"rank{r}.pt")],
            cwd=HERE, env=env, stdout=logs[r], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_TIMEOUT
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    failed = [r for r, p in enumerate(procs) if p.poll() != 0]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed:
        for r in failed:
            logs[r].seek(0)
            tail = logs[r].read()[-4000:]
            print(f"{phase}: rank {r} log (end):\n{tail}", file=sys.stderr)
        die(f"{phase}: ranks {failed} failed or outlived the {DP_TIMEOUT} s timeout")
    logs[0].seek(0)
    rank0_log = logs[0].read()
    for f in logs:
        f.close()
    return ([torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(n)], rank0_log)


def gate_step(phase: str, what: str, ranks: list, one: tuple, rtol: float = RTOL,
              stats=None) -> None:
    """The gate of phases 7 (b) and 14 (c): every rank's metrics and whole
    state (``ranks``: (metrics, state) each) equal; the metrics within
    ``rtol`` of the one-process step's (``one``); the updated parameters
    within 2 lr (Adam's first update is about lr sign(g)) plus one float32
    rounding of the largest. The BatchNorm running statistics are forward
    statistics, which no lr bounds: ``stats`` None holds them to the same
    bound (phase 7), "print" prints their distance, a dict (rtol, atol)
    holds them to it."""
    import torch

    (m_dp, p_dp), (m_one, p_one) = ranks[0], one
    for k in p_dp:
        for r, (_, p_r) in enumerate(ranks[1:], 1):
            if not torch.equal(p_dp[k], p_r[k]):
                die(f"{phase}: {k} differs between ranks 0 and {r}")
    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    for name in names:
        if not math.isclose(m_dp[name], m_one[name], rel_tol=rtol, abs_tol=1e-30) or \
                any(m_r[name] != m_dp[name] for m_r, _ in ranks[1:]):
            die(f"{phase}: {name} ranks {[m_r[name] for m_r, _ in ranks]!r} vs one "
                f"process {m_one[name]!r}")
    diffs = {k: (p_dp[k].double() - p_one[k].double()).abs() for k in p_one}
    is_stat = {k: k.endswith(("running_mean", "running_var")) for k in diffs}
    bounded = {k: d for k, d in diffs.items() if stats is None or not is_stat[k]}
    worst_key = max(bounded, key=lambda k: float(bounded[k].max()))
    worst = float(bounded[worst_key].max())
    n_over = sum(int((d > ATOL).sum()) for d in diffs.values())
    n_params = sum(d.numel() for d in diffs.values())
    bn_key = max((k for k in diffs if is_stat[k]), key=lambda k: float(diffs[k].max()))
    bn_worst = float(diffs[bn_key].max())
    # an update of +lr against one of -lr, plus one float32 rounding of the
    # largest parameter
    bound = 2 * LR + float(torch.finfo(torch.float32).eps) * max(
        float(v.abs().max()) for v in p_one.values() if v.is_floating_point())
    checked = "params and BN stats" if stats is None else "params"
    if not worst <= bound:
        die(f"{phase}: updated {checked} differ by {worst!r} ({worst_key}) > 2 lr + 1 ulp "
            f"= {bound!r}")
    if isinstance(stats, dict):
        for k in (k for k in diffs if is_stat[k]):
            if not torch.allclose(p_dp[k].double(), p_one[k].double(), **stats):
                die(f"{phase}: {k} differs by {float(diffs[k].max())!r} beyond {stats}")
    dtype = "float64" if p_one[worst_key].dtype == torch.float64 else "fp32 (TF32 off)"
    print(f"{phase}: one {dtype} step, {what} vs one process: metrics within rtol {rtol} "
          + json.dumps({n: [m_dp[n], m_one[n]] for n in names})
          + f"; updated {checked} max abs diff {worst!r} ({worst_key}; <= 2 lr + 1 ulp = "
          f"{bound!r}), {n_over} of {n_params} entries over {ATOL}; BN running stats max "
          f"abs diff {bn_worst:.3g} ({bn_key}"
          + ("" if not isinstance(stats, dict) else f"; within {stats}")
          + "); all ranks bit-equal")


def phase_data_parallel(card: str) -> dict:
    """Phase 7: the data-parallel path, configs/intro_tc_128_dp8.json at
    full width (conv arch, 128x128x3, channels 64-512, z 128, global batch
    128, bf16, paired) with DP_UPDATE, as DP_RANKS processes on the one
    card (backend gloo: ranks that share a card), each started as a user
    would (env vars, the CLI's entry).

    (a) One epoch, 1280 images / 128 = 10 steps: every loss finite and the
    same on both ranks; per rank and step, 3 gathered TC calls in phase E
    and 2 in phase D, each launching tc_fwd, tc_bwd_dz and tc_bwd_dmu once;
    0 single-device TC calls, 0 conv kernel launches (conv_impl auto is
    xla); the ranks' parameters bit-equal after the epoch.
    (b) One fp32 step (TF32 off) on the ranks against the same step in
    this process on the whole batch (same weights, batch, noise): metrics
    within rtol 1e-4; updated parameters within 2 lr (Adam's first update
    is about lr sign(g)) plus one float32 rounding; the ranks' parameters
    and BatchNorm statistics equal."""
    import shutil
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    ranks, rank0_log = start_ranks("phase 7", DP_RANKS, ["--dp-rank"], work)
    saves = sorted(os.listdir(os.path.join(work, "saves")))
    dp_digest = dp_checkpoint_digest(os.path.join(work, "saves", saves[-1])) if saves else None
    shutil.rmtree(work)

    # (a)
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset

    cfg = load_config(DP_CONFIG, DP_UPDATE)
    steps = len(load_dataset(cfg.dataset)[0]) // cfg.batch_size  # 1280 / 128
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, conv_cuda

    want_e = {"tc_fwd": 3, "tc_bwd_dz": 3, "tc_bwd_dmu": 3,
              **dict.fromkeys(conv_cuda.KERNELS, 0), **dict.fromkeys(batchnorm_cuda.KERNELS, 0),
              "calls.tc_logsumexp": 0, "calls.tc_logsumexp_gathered": 3}
    want_d = {**want_e, "tc_fwd": 2, "tc_bwd_dz": 2, "tc_bwd_dmu": 2,
              "calls.tc_logsumexp_gathered": 2}
    for r, out in enumerate(ranks):
        a = out["train"]
        if len(a["history"]) != steps:
            die(f"phase 7: rank {r}: {len(a['history'])} steps, expected {steps}")
        for rec in a["history"]:
            for k, v in rec.items():
                if isinstance(v, float) and not math.isfinite(v):
                    die(f"phase 7: rank {r}: non-finite {k} at step {rec['step']}")
        for label, got, want in (("phase E", a["phase_e"], want_e),
                                 ("phase D", a["phase_d"], want_d),
                                 ("total", a["counts"],
                                  {k: want_e[k] + want_d[k] for k in want_e})):
            want = {k: steps * v for k, v in want.items()}
            if got != want:
                die(f"phase 7: rank {r}: {label} counts {got}, expected {want}")
        if a["backend"] != "gloo" or a["device"] != DP_DEVICE:
            die(f"phase 7: rank {r}: backend {a['backend']}, device {a['device']}")
    a0, a1 = ranks[0]["train"], ranks[1]["train"]
    for x, y in zip(a0["history"], a1["history"]):
        if {k: v for k, v in x.items() if k != "seconds"} != \
                {k: v for k, v in y.items() if k != "seconds"}:
            die(f"phase 7: the ranks' metrics differ at step {x['step']}: {x} vs {y}")
    if a0["digest"] != a1["digest"]:
        die("phase 7: the ranks' parameters differ after the epoch")
    rate = a0["rate"]
    last = a0["history"][-1]
    print(f"phase 7 (a): {DP_RANKS} ranks (gloo, one card), {steps} steps of global batch "
          f"{cfg.batch_size}, finite losses (last lossE {last['lossE']:.6g} lossD "
          f"{last['lossD']:.6g}), equal on both ranks; per rank phase E {a0['phase_e']}, "
          f"phase D {a0['phase_d']}; parameters bit-equal")
    print(f"phase 7 (a): {rate} img/s (global batch, steps 5-{steps}, bf16) on {card}: "
          f"two ranks share one card and every collective goes through the host (gloo), "
          f"so this is not a scaling figure")
    for line in rank0_log.splitlines():
        if line.startswith(("distributed:", "training throughput")):
            print(f"phase 7 (a): rank 0 says: {line}")

    # (b)
    torch.cuda.empty_cache()
    gate_step("phase 7 (b)", f"{DP_RANKS} ranks",
              [(out["metrics"], out["params"]) for out in ranks],
              dp_step(torch.device(DP_DEVICE)))
    calls = sum(out["train"]["counts"]["calls.tc_logsumexp_gathered"] for out in ranks)

    # (g), phase 8's part here: the ranks' one final checkpoint, written by
    # rank 0, loaded in this process, holds both ranks' parameters
    want = f"{cfg.fingerprint()}model_epoch_0_iter_{steps}"
    if saves != [want]:
        die(f"phase 8 (g): the ranks left {saves}, expected [{want!r}]")
    for r, out in enumerate(ranks):
        if out["train"]["digest"] != dp_digest:
            die(f"phase 8 (g): the checkpoint differs from rank {r}'s parameters")
    print(f"phase 8 (g): {DP_RANKS} ranks, one checkpoint {want} (rank 0 wrote it); loaded in "
          "one process it equals both ranks' parameters and BatchNorm statistics bit for bit")
    return {"gathered_calls": calls, "rate": rate}


def dp_checkpoint_digest(path: str) -> str:
    """state_digest of the dp8 model holding the checkpoint's weights."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.parallel import state_digest
    from intro_tc_vae_tpu_torch.utils import load_model

    cfg = load_config(DP_CONFIG, DP_UPDATE)
    _, size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=tuple(channels),
              image_size=size)
    model = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(DP_DEVICE)
    return state_digest(load_model(model, path))


def same(a, b) -> bool:
    """Equal structure and values, tensors bit for bit (dtype and shape too)."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def train_state_parts(state) -> dict:
    return {"step": state.step, "model": state.model.state_dict(),
            "opt_e": state.opt_e.state_dict(), "opt_d": state.opt_d.state_dict()}


def phase_checkpoints(card: str) -> dict:
    """Phase 8: checkpoint, resume and sampling on the card, at the
    flagship's full width (FLAGSHIP on synthetic: 64x64x3, conv 64-512, z
    128, batch 64, bf16, paired, tc_impl and conv_impl 'pallas'); every file
    in a temporary directory, deleted afterwards.
    (a) One epoch, 20 steps, through the CLI, which writes its final
    checkpoint; the eval-mode decode after the last step (the launches
    after the decoder's last optimizer call) launches 3 conv3x3_fwd_wgmma
    and their 3 weight packs, and no other kernel.
    (b) Loaded into a fresh state (other weights): parameters, BatchNorm
    statistics, both Adam states and the step bit-equal to the saved ones.
    (d) A background save equals a synchronous save of the same state.
    (c) One step from the restored state and one from the saved state, on
    the same batch and noise, cuDNN deterministic: bit-equal results.
    (e) resume "auto" with num_epochs 2 continues the step count from 20;
    its checkpoint ranks after (a)'s.
    (f) ``python -m intro_tc_vae_tpu_torch.sample`` on (a)'s checkpoint
    writes a PNG whose pixels equal the u8 decode of the same seed's noise
    in this process; the sampler launches no hand kernel.
    (g) is phase 7's: the data-parallel ranks' checkpoint."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from intro_tc_vae_tpu_torch import sample
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers.base import decode, draw_noise
    from intro_tc_vae_tpu_torch.train import build_solver, setup, true_fp32
    from intro_tc_vae_tpu_torch.utils.checkpoint import (
        finalize_checkpoints,
        find_latest_checkpoint,
        load_checkpoint,
        load_model,
        save_checkpoint,
    )

    work = tempfile.mkdtemp(prefix="chip_smoke_phase8_")
    try:
        saves = os.path.join(work, "saves")
        update = {"dataset": "synthetic", "tc_impl": "pallas", "conv_impl": "pallas",
                  "num_epochs": 1, "use_tensorboard": False, "checkpoint_dir": saves}
        config = load_config(FLAGSHIP, update)
        prefix = config.fingerprint()
        dev = torch.device("cuda", 0)

        # (a)
        from intro_tc_vae_tpu_torch.ops import launch_counts

        marks = {}
        handle = launch_counts.on_mark(lambda: marks.update(last=all_launches()))
        reset_all_launches()
        try:
            state_a = run_cli(FLAGSHIP, update, "phase 8 (a)")
        finally:
            handle.remove()
        end = all_launches()
        after = {k: end[k] - marks["last"][k] for k in end}
        want = {**dict.fromkeys(end, 0), **final_decode_launches("pallas")}
        if after != want:
            die(f"phase 8 (a): the eval decode launched {after}, expected {want}")
        x = state_a.samples
        if (x is None or tuple(x.shape) != (MAIN_B, 3, 64, 64) or not bool(torch.isfinite(x).all())
                or float(x.min()) < 0 or float(x.max()) > 1):
            die(f"phase 8 (a): the eval decode gave {None if x is None else tuple(x.shape)}, "
                "expected finite [64, 3, 64, 64] in [0, 1]")
        path_a = find_latest_checkpoint(saves, prefix)
        name_a = f"{prefix}model_epoch_0_iter_20"
        if path_a is None or os.path.basename(path_a) != name_a or os.listdir(saves) != [name_a]:
            die(f"phase 8 (a): checkpoints {os.listdir(saves)}, expected [{name_a!r}]")
        size = os.path.getsize(path_a)
        print(f"phase 8 (a): 20 steps, final checkpoint {name_a}, {size} bytes; the eval "
              f"decode after the last step launched {after}")

        # (b)
        run_b = setup(config, dev)
        with torch.no_grad():
            for p in run_b.state.model.parameters():
                p.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, epoch = load_checkpoint(path_a, run_b.state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        saved, restored = train_state_parts(state_a), train_state_parts(run_b.state)
        for part in saved:
            if not same(saved[part], restored[part]):
                die(f"phase 8 (b): the restored {part} differs from the saved one")
        if restored["step"] != 20 or epoch != 0:
            die(f"phase 8 (b): restored step {restored['step']}, epoch {epoch}")
        n_adam = sum(len(s["state"]) for s in (restored["opt_e"], restored["opt_d"]))
        print(f"phase 8 (b): loaded in {load_s:.3f} s into a fresh state: parameters, BatchNorm "
              f"statistics, both Adam states ({n_adam} parameters' exp_avg, exp_avg_sq, step) "
              "and the step (20) bit-equal to the saved ones")

        # (d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_sync = save_checkpoint(state_a, 0, 20, "sync_", os.path.join(work, "d"))
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_async = save_checkpoint(state_a, 0, 20, "async_", os.path.join(work, "d"),
                                  async_save=True)
        async_return_s = time.perf_counter() - t0
        finalize_checkpoints()
        async_s = time.perf_counter() - t0
        if not same(load_checkpoint(p_sync), load_checkpoint(p_async)):
            die("phase 8 (d): the background save differs from the synchronous one")
        print(f"phase 8 (d): a background save equals a synchronous one; save {sync_s:.3f} s "
              f"synchronous, {async_return_s:.3f} s to return and {async_s:.3f} s to the file "
              f"in the background; {size} bytes on {card}")

        # (c)
        solver_a = build_solver(config, run_b.solver.dataset, state_a.model.encoder,
                                state_a.model.decoder, run_b.mesh)
        batch = next(iter(run_b.loader))
        noise = draw_noise(torch.Generator(device=dev).manual_seed(11), MAIN_B, Z_DIM, dev)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            _, m_a = solver_a.train_step(state_a, batch, noise)
            _, m_b = run_b.solver.train_step(run_b.state, batch, noise)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if not same(state_a.model.state_dict(), run_b.state.model.state_dict()):
            die("phase 8 (c): a step from the restored state differs from one from the saved")
        if {k: float(v) for k, v in m_a.items()} != {k: float(v) for k, v in m_b.items()}:
            die(f"phase 8 (c): metrics differ: {m_a} vs {m_b}")
        print("phase 8 (c): one step from the restored state and one from the saved state "
              "(same batch and noise, cuDNN deterministic): parameters, statistics and "
              "metrics bit-equal")
        del run_b, solver_a, state_a
        torch.cuda.empty_cache()

        # (e)
        state_e = run_cli(FLAGSHIP, {**update, "num_epochs": 2, "resume": "auto"},
                          "phase 8 (e)", steps=40)
        steps = [r["step"] for r in state_e.history]
        name_e = f"{prefix}model_epoch_1_iter_60"
        latest = find_latest_checkpoint(saves, prefix)
        if steps != list(range(21, 61)) or os.path.basename(latest or "") != name_e:
            die(f"phase 8 (e): steps {steps[0]}..{steps[-1]}, newest checkpoint {latest}")
        print(f"phase 8 (e): resume auto from {name_a}: steps 21-60 (epoch 0 again, then 1), "
              f"newest checkpoint {name_e}")
        del state_e
        torch.cuda.empty_cache()

        # (f)
        png = os.path.join(work, "samples.png")
        argv = ["--checkpoint", path_a, "--dataset", "synthetic", "--arch", "conv",
                "--z-dim", str(Z_DIM), "--num", "16", "--seed", "3"]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "intro_tc_vae_tpu_torch.sample", *argv,
                              "--out", png], cwd=HERE, capture_output=True, text=True,
                             timeout=300)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0 or not os.path.exists(png):
            die(f"phase 8 (f): the sampler failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        written = np.asarray(Image.open(png))
        reset_all_launches()
        grid = sample.main([*argv, "--out", os.path.join(work, "again.png")])
        launched = {k: v for k, v in all_launches().items() if v}
        if launched:
            die(f"phase 8 (f): the sampler launched {launched}")
        kw = dict(arch="conv", cdim=3, zdim=Z_DIM, channels=(64, 128, 256, 512), image_size=64)
        model = load_model(SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev), path_a)
        with true_fp32("fp32"):
            z = torch.randn((16, Z_DIM), generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev)
            want = sample.sample_grid(sample.to_host_u8(decode(model.decoder, z, train=False)))
        if not (np.array_equal(written, want) and np.array_equal(grid, want)):
            die(f"phase 8 (f): the PNG {written.shape} differs from the in-process decode "
                f"{want.shape}")
        print(f"phase 8 (f): python -m intro_tc_vae_tpu_torch.sample wrote {written.shape} "
              f"({cli_s:.1f} s with start-up) equal to the in-process u8 decode of the same "
              "noise; no hand kernel launched")
    finally:
        shutil.rmtree(work)
    return {"save_s": sync_s, "async_return_s": async_return_s, "load_s": load_s,
            "bytes": size}


# ---------------------------------------------------------------------------
# phase 9: the data paths
# ---------------------------------------------------------------------------

DSPRITES_NPZ = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
DSPRITES_ROWS = 1300     # 20 steps of 64, and 20 rows the epoch drops
UKIYO_IMAGES = 1280      # 20 steps of 64
DATA_SEED, FLIP_SEED = 9, 17
PAINTERS = ("Kunisada", "Hiroshige", "Kuniyoshi", "Toyokuni", "Yoshitoshi", "Hokusai",
            "Kunichika", "Eisen")
# (transfer_dtype, device_cache) of each data path
DATA_ARMS = {"float32": {"transfer_dtype": "float32", "device_cache": "off"},
             "uint8": {"transfer_dtype": "uint8", "device_cache": "off"},
             "cache": {"device_cache": "force"}}


def write_dsprites(root: str) -> None:
    """A dSprites-layout npz at the real 64x64: ``imgs`` 0/1 uint8 sprites
    (squares, ellipses, diamonds at random places and scales) and
    ``latents_values`` [N, 6] (color 1, shape 1-3, scale, orientation,
    posX, posY), from a seeded RNG."""
    import numpy as np

    rng = np.random.RandomState(DATA_SEED)
    n = DSPRITES_ROWS
    shape = rng.randint(0, 3, n)
    scale = rng.choice(np.linspace(0.5, 1.0, 6), n)
    px, py = rng.choice(np.linspace(0, 1, 32), n), rng.choice(np.linspace(0, 1, 32), n)
    r = (scale * 12)[:, None, None]
    cx, cy = (12 + px * 40)[:, None, None], (12 + py * 40)[:, None, None]
    yy, xx = np.mgrid[0:64, 0:64]
    dx, dy = np.abs(xx[None] - cx), np.abs(yy[None] - cy)
    sel = shape[:, None, None]
    imgs = np.where(sel == 0, np.maximum(dx, dy) <= r,
                    np.where(sel == 1, dx**2 + (1.5 * dy) ** 2 <= r**2, dx + dy <= r))
    lv = np.stack([np.ones(n), shape + 1.0, scale, np.zeros(n), px, py], axis=1)
    np.savez(os.path.join(root, DSPRITES_NPZ), imgs=imgs.astype(np.uint8), latents_values=lv)


def write_ukiyo(root: str, n_images: int = UKIYO_IMAGES) -> None:
    """An ARC Ukiyo-E-layout directory: ``n_images`` procedural 256x256
    JPEGs (smooth colour fields, PIL) under arc_extracted_face_images/ and
    the 27-column metadata CSV naming each file and its painter."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from intro_tc_vae_tpu_torch.data import UkiyoE

    rng = np.random.RandomState(DATA_SEED + 1)
    images = os.path.join(root, "arc_extracted_face_images")
    os.makedirs(images)
    seeds = rng.randint(0, 256, (n_images, 6, 6, 3)).astype(np.uint8)
    names = [f"{i:08d}.jpg" for i in range(n_images)]

    def one(i):
        img = Image.fromarray(seeds[i]).resize((256, 256), Image.BICUBIC)
        img.save(os.path.join(images, names[i]), quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(n_images)))
    painters = rng.randint(0, len(PAINTERS), n_images)
    with open(os.path.join(root, "arc_extracted_face_metadata.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(UkiyoE.COLUMN_NAMES)
        for i, name in enumerate(names):
            row = [f"arcFX{i:05d}"] + [""] * 26
            row[9], row[11], row[13], row[26] = PAINTERS[painters[i]], 1850, "Edo", name
            out.writerow(row)


def loader_epochs(make_dataset, label: str, card: str) -> dict:
    """(c) for one dataset: an epoch of batch 64 on each path on the card
    (prefetch 2), each batch normalized as the train step normalizes it,
    bit-equal across the paths and to the host's float path (a loader on
    the CPU); host ms per batch from the recorder's loader spans and H2D
    bytes per step from the loader's stats. ``make_dataset()`` gives a
    fresh dataset with the injected flip stream, so every path draws the
    same flips."""
    import torch

    from intro_tc_vae_tpu_torch.data import DeviceLoader
    from intro_tc_vae_tpu_torch.solvers.base import normalize_input
    from intro_tc_vae_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    host = list(DeviceLoader(make_dataset(), MAIN_B, torch.device("cpu"), seed=DATA_SEED))
    out = {}
    for path, kw in DATA_ARMS.items():
        loader = DeviceLoader(make_dataset(), MAIN_B, dev, seed=DATA_SEED, **kw)
        t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
        batches = [normalize_input(b) for b in loader]
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        host_ns, _ = tracing.RECORDER.span_ns(("loader.batch", "loader.make"), t0_ns,
                                              time.perf_counter_ns())
        if (loader.cache is not None) != (path == "cache"):
            die(f"phase 9 (c): {label} {path}: cache {loader.cache is not None}")
        if len(batches) != len(host) or len(host) != 20:
            die(f"phase 9 (c): {label} {path}: {len(batches)} batches, host {len(host)}")
        for k, (b, h) in enumerate(zip(batches, host)):
            if b.dtype != torch.float32 or not torch.equal(b, h.to(dev)):
                die(f"phase 9 (c): {label} {path}: batch {k} differs from the host float path")
        st = loader.stats
        out[path] = {"host_ms_per_batch": 1e-6 * host_ns / st.batches,
                     "h2d_bytes_per_step": st.h2d_bytes / st.batches,
                     "epoch_ms": 1e3 * epoch_s}
    print(f"phase 9 (c): {label}: float32, uint8 and cache paths, one epoch of 20 batches "
          f"each, bit-equal to each other and to the host float path; per path "
          + json.dumps({p: {k: round(v, 3) for k, v in r.items()} for p, r in out.items()})
          + f" on {card}")
    return out


def run_cli_captured(config: str, update: dict, name: str):
    """``run_cli`` with the run's printed lines captured; returns (state,
    lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = run_cli(config, update, name)
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(("device cache:", "training throughput:")):
            print(f"{name}: {line}")
    return state, lines


def phase_data_paths(card: str, main_path: dict) -> dict:
    """Phase 9: the file-backed datasets, the native data core, the
    prefetching loader, uint8 transfer and the device-resident cache, at
    the flagship's full width; every file in a temporary directory.
    (a) The native data core (built in phase 2) is loaded.
    (b) A dSprites-layout npz (DSPRITES_ROWS rows at 64x64) and an
    ARC Ukiyo-E-layout directory (UKIYO_IMAGES 256x256 JPEGs and the
    27-column CSV), from a seeded RNG.
    (c) Per dataset (dSprites; Ukiyo-E at 64 px, its decode cache built
    once and timed, flips from one injected RNG): the float32, uint8 and
    cache paths of the loader give bit-equal float batches on the card for
    a whole epoch, equal to the host's float path; the uint8 table on the
    card equals numpy's /255 for all 256 values.
    (d) configs/tc_dsprites.json through the CLI in the three data arms
    (fp32, TF32 off, cuDNN deterministic): 20 finite steps each, the cache
    arm reports the cache, the per-step losses agree across arms (rtol
    1e-5).
    (e) configs/intro_tc_ukiyo64.json through the CLI on its own
    ukiyo_e64 layout, the defaults (transfer auto, cache auto: the cache
    engages), tc_impl and conv_impl 'pallas': 20 finite steps, every
    kernel launched as often as in phase 4's (pallas, pallas) arm, no conv
    body but the wgmma one.
    (f) The timings of (c), (d) and (e)."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.data import DSprites, UkiyoE
    from intro_tc_vae_tpu_torch.runtime import native
    from intro_tc_vae_tpu_torch.solvers.base import u8_to_unit_f32
    from intro_tc_vae_tpu_torch.train import images_per_second

    # (a)
    if not native.available():
        die("phase 9 (a): the native data core did not load")
    print(f"phase 9 (a): native data core {os.path.relpath(native.library_path(), HERE)} "
          "loaded")

    work = tempfile.mkdtemp(prefix="chip_smoke_phase9_")
    try:
        # (b)
        t0 = time.perf_counter()
        dsprites_root = os.path.join(work, "dsprites")
        ukiyo_root = os.path.join(work, "ukiyo")
        os.makedirs(dsprites_root)
        write_dsprites(dsprites_root)
        write_ukiyo(ukiyo_root)
        print(f"phase 9 (b): wrote {DSPRITES_ROWS} dSprites rows and {UKIYO_IMAGES} Ukiyo-E "
              f"JPEGs in {time.perf_counter() - t0:.1f} s")

        # (c)
        u8 = torch.arange(256, dtype=torch.uint8, device="cuda").reshape(1, 1, 16, 16)
        want = np.arange(256, dtype=np.float32) / 255.0
        if not np.array_equal(u8_to_unit_f32(u8).cpu().numpy().ravel(), want):
            die("phase 9 (c): the uint8 table on the card differs from numpy's /255")
        plain = (u8.float() / 255).cpu().numpy().ravel()
        print("phase 9 (c): u8_to_unit_f32 on the card equals numpy's /255 for all 256 "
              f"values; a plain divide on the card differs in {int((plain != want).sum())}")
        dsprites = DSprites.load_data(data_root=dsprites_root)
        ukiyo = UkiyoE.load_data(resize=64, data_root=ukiyo_root)
        t0 = time.perf_counter()
        ukiyo.raw_array()
        decode_s = time.perf_counter() - t0

        def ukiyo_copy():
            ds = copy.copy(ukiyo)  # shares the decoded cache
            ds._rng = np.random.RandomState(FLIP_SEED)
            return ds

        print(f"phase 9 (c): Ukiyo-E decode cache ({len(ukiyo)} images, 256 px JPEG to "
              f"64 px uint8, {ukiyo.decode_workers} threads) built in {decode_s:.3f} s "
              f"on {card}")
        loaders = {"dsprites": loader_epochs(lambda: dsprites, "dSprites 64x64x1", card),
                   "ukiyo_e64": loader_epochs(ukiyo_copy, "Ukiyo-E 64x64x3", card)}
        del dsprites, ukiyo

        # (d)
        base = {"data_root": dsprites_root, "num_epochs": 1, "use_tensorboard": False}
        runs, rates = {}, {}
        with fp32_exact():
            for arm, update in DATA_ARMS.items():
                state, lines = run_cli_captured(TC_DSPRITES, {**base, **update},
                                                f"phase 9 (d) {arm}")
                cached = any(line.startswith("device cache:") for line in lines)
                if cached != (arm == "cache"):
                    die(f"phase 9 (d): {arm}: the cache {'engaged' if cached else 'did not'}")
                runs[arm], rates[arm] = state.history, images_per_second(state, MAIN_B)
        worst = 0.0
        for arm in ("uint8", "cache"):
            for a, b in zip(runs[arm], runs["float32"]):
                for k in ("loss_enc", "loss_kl", "loss_rec"):
                    rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                    worst = max(worst, rel)
                    if rel > 1e-5:
                        die(f"phase 9 (d): {arm} step {a['step']} {k} {a[k]!r} vs float32 "
                            f"{b[k]!r}")
        print(f"phase 9 (d): tc_dsprites in three data arms: 20 finite steps each, the cache "
              f"engaged in the cache arm only, losses agree (largest relative difference "
              f"{worst:.3g}); img/s (steps 5-20, fp32 TF32 off, batch 64) "
              + json.dumps({k: round(v, 1) for k, v in rates.items()}) + f" on {card}")
        del runs

        # (e)
        update = {"data_root": ukiyo_root, "use_tensorboard": False, "num_epochs": 1,
                  "tc_impl": "pallas", "conv_impl": "pallas"}
        reset_all_launches()
        state, lines = run_cli_captured(FLAGSHIP, update, "phase 9 (e)")
        counts = all_launches()
        if not any(line.startswith("device cache:") for line in lines):
            die("phase 9 (e): the flagship on ukiyo_e64 did not engage the cache")
        if counts != main_path["launches"]:
            die(f"phase 9 (e): launches {counts}, phase 4's (pallas, pallas) "
                f"{main_path['launches']}")
        if any(counts[k] for k in ("conv3x3_fwd", "conv3x3_dw", "conv3x3_fwd_ragged",
                                   "conv3x3_dw_ragged")):
            die(f"phase 9 (e): a conv body other than the wgmma one launched: {counts}")
        rate = images_per_second(state, MAIN_B)
        synthetic = main_path["rates"]["tc pallas, conv pallas"]
        print(f"phase 9 (e): the flagship on ukiyo_e64 (auto/auto: the cache engaged), tc and "
              f"conv pallas: 20 finite steps, launches equal to phase 4's (pallas, pallas), "
              f"0 of any conv body but the wgmma one; {rate:.1f} img/s (steps 5-20) against phase 4's "
              f"{synthetic:.1f} on synthetic, on {card}")
        del state
    finally:
        shutil.rmtree(work)
    return {"decode_s": decode_s, "loaders": loaders, "tc_dsprites_rates": rates,
            "flagship_ukiyo_rate": rate}


# ---------------------------------------------------------------------------
# phase 10: observability and evaluation
# ---------------------------------------------------------------------------

DSPRITES_GRID_PX = 8      # the full grid's stored size (the archive's: 64)
OBS_TEST_ITER = {"flagship": 10, "tc_dsprites": 56}  # heavy metrics at 0 and test_iter
# each sklearn-backed score's writer and a sub-run it writes
SKLEARN_SUBRUN = {"write_bvae_score": "bvae_score_score",
                  "write_dci_score": "dci_dci_completeness_score",
                  "write_mod_expl_score": "mod_expl_explicitness_score"}
SKLEARN_SCORES = tuple(SKLEARN_SUBRUN)
INCEPTION_IMAGES = 640


def write_dsprites_grid(root: str) -> None:
    """A dSprites-layout npz on the archive's full factor grid: 737,280 rows
    in its mixed-radix order (so the latent generator's factors index real
    rows), each sprite rendered from its shape, scale and position at
    DSPRITES_GRID_PX px (the dataset resizes to 64), from no RNG."""
    import numpy as np

    grids = [np.array([1.0]), np.arange(1.0, 4.0), np.linspace(0.5, 1.0, 6),
             np.linspace(0.0, 2.0 * np.pi, 40), np.linspace(0.0, 1.0, 32),
             np.linspace(0.0, 1.0, 32)]
    lv = np.stack([g.ravel() for g in np.meshgrid(*grids, indexing="ij")], axis=1)
    s = DSPRITES_GRID_PX
    r = (lv[:, 2] * s / 4).astype(np.float32)[:, None, None]
    cx = (1.5 + lv[:, 4] * (s - 3)).astype(np.float32)[:, None, None]
    cy = (1.5 + lv[:, 5] * (s - 3)).astype(np.float32)[:, None, None]
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    dx, dy = np.abs(xx[None] - cx), np.abs(yy[None] - cy)
    shape = lv[:, 1][:, None, None]
    imgs = np.where(shape == 1, np.maximum(dx, dy) <= r,
                    np.where(shape == 2, dx**2 + (1.5 * dy) ** 2 <= r**2, dx + dy <= r))
    np.savez(os.path.join(root, DSPRITES_NPZ), imgs=imgs.astype(np.uint8), latents_values=lv)


@contextlib.contextmanager
def timed_calls(*targets):
    """Wraps each (owner, attribute, sync) callable for the block: its
    seconds (after a CUDA synchronize where ``sync``) and calls, by
    attribute name."""
    import functools

    import torch

    stats = {name: [0.0, 0] for _, name, _ in targets}
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]

    def wrap(name, fn, sync):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                stats[name][0] += time.perf_counter() - t0
                stats[name][1] += 1
        return inner

    for (owner, name, fn), (_, _, sync) in zip(saved, targets):
        setattr(owner, name, wrap(name, fn, sync))
    try:
        yield stats
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def eval_encoder_devices():
    """The device of every input an encoder got in eval mode in the block
    (the heavy metrics' encodes)."""
    import torch

    from intro_tc_vae_tpu_torch.models import Encoder

    seen = set()

    def hook(module, args):
        if isinstance(module, Encoder) and not module.training:
            seen.add(args[0].device.type)

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def observed_cli(config: str, update: dict, name: str, steps: int):
    """``run_cli`` with the heavy metrics' and the drains' writes timed and
    the printed lines captured: (state, lines, per-call stats, devices of
    the eval-mode encodes)."""
    import io

    from torch.utils.tensorboard import SummaryWriter

    from intro_tc_vae_tpu_torch.evaluation import metrics as em
    from intro_tc_vae_tpu_torch.solvers.base import VAESolver

    buf = io.StringIO()
    with (timed_calls((VAESolver, "_write_images_helper", True),
                      (VAESolver, "_write_scalar_metrics", False),
                      (SummaryWriter, "flush", False),
                      *((em, w, True) for w in ("write_bvae_score", "write_dci_score",
                                                "write_mig_score", "write_mod_expl_score")))
          as stats, eval_encoder_devices() as devices, contextlib.redirect_stdout(buf)):
        state = run_cli(config, update, name, steps)
    return state, buf.getvalue().splitlines(), stats, devices


def read_run(log_root: str, name: str, config: str):
    """The one run under ``log_root`` through the port's tb_reader, which
    finds it by the config's hparam fingerprint too."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.utils.tb_reader import TensorboardReader

    runs = os.listdir(log_root)
    if len(runs) != 1:
        die(f"phase 10 {name}: runs {runs} under {log_root}")
    reader = TensorboardReader(log_root, runs[0])
    c = load_config(config)
    found = TensorboardReader.get_reader(log_root, c.arch, c.beta_kl, c.beta_neg, c.beta_rec,
                                         c.gamma_r)
    if found.run_path != reader.run_path:
        die(f"phase 10 {name}: the fingerprint found {found.run_path}, not {reader.run_path}")
    return reader


def check_steps(name: str, label: str, df, want: list) -> None:
    import numpy as np

    got = list(df["step"])
    if got != want or not np.isfinite(df["value"]).all():
        die(f"phase 10 {name}: {label} at steps {got}, expected {want} (finite)")


def heavy_seconds(stats: dict, fires: int) -> dict:
    """Seconds of one test_iter's heavy metrics: the image grid and each score."""
    keys = ("_write_images_helper", "write_bvae_score", "write_dci_score", "write_mig_score",
            "write_mod_expl_score")
    return {("images" if k.startswith("_") else k[6:]): stats[k][0] / fires
            for k in keys if stats[k][1]}


def drain_ms(stats: dict) -> float:
    """Host ms of one drain's writes: every step's scalars and one flush."""
    flushes = stats["flush"][1]
    return 1e3 * (stats["_write_scalar_metrics"][0] + stats["flush"][0]) / max(flushes, 1)


def phase_observability(card: str, main_path: dict) -> dict:
    """Phase 10: TensorBoard, the disentanglement metrics and FID on the card;
    every file in a temporary directory.
    (a) configs/intro_tc_ukiyo64.json as shipped (use_tensorboard on), tc and
    conv 'pallas', on phase 9's Ukiyo-E layout (``write_ukiyo``, the same
    seed): one epoch of 20 steps, test_iter 10 (the image grid at 0 and 10,
    and after the epoch at 20; the dataset has no factors, so no scores);
    finite losses; the launches of phase 4's (pallas, pallas) arm plus the
    grids' five eval decodes; every expected tag read back through the
    port's tb_reader, which also finds the run by its fingerprint.
    (b) configs/tc_dsprites.json (use_tensorboard on), tc and conv 'pallas',
    on a dSprites layout where the factors exist (``write_dsprites_grid``;
    dataset dsprites_small, the repo's 7,200-row grid subset): one epoch of
    112 steps, test_iter 56; MIG and modularity written at 0 and 56; each
    sklearn-backed score written, or failed with ModuleNotFoundError for
    sklearn and nothing else; every eval-mode encode on the card.
    (c) ``python -m intro_tc_vae_tpu_torch.evaluate --fid`` on (a)'s final
    checkpoint, with a random-valued Inception state_dict as
    ITCVAE_INCEPTION_WEIGHTS; the Inception net on the card against itself
    on the CPU (float32, TF32 off; rtol 1e-4, atol 1e-5 of the largest
    feature, tests/test_torch_fid.py's tolerance); its img/s.
    Printed: the seconds of one test_iter's heavy metrics (the grid, each
    score), the host ms a drain's writes add, Inception img/s."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_phase10_")
    try:
        return observe(card, main_path, work)
    finally:
        shutil.rmtree(work)


def observe(card: str, main_path: dict, work: str) -> dict:
    """Phase 10's (a), (b) and (c) in ``work``; returns their measurements."""
    import io

    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch import evaluate
    from intro_tc_vae_tpu_torch.models import inception
    from intro_tc_vae_tpu_torch.train import images_per_second

    out = {}
    # (a)
    ukiyo_root = os.path.join(work, "ukiyo")
    write_ukiyo(ukiyo_root)
    log_a, saves_a = os.path.join(work, "runs_a"), os.path.join(work, "saves_a")
    update = {"data_root": ukiyo_root, "num_epochs": 1, "tc_impl": "pallas",
              "conv_impl": "pallas", "test_iter": OBS_TEST_ITER["flagship"],
              "log_dir": os.path.join(log_a, "tb"), "checkpoint_dir": saves_a}
    reset_all_launches()
    state, lines, stats, devices = observed_cli(FLAGSHIP, update, "phase 10 (a)", 20)
    counts = all_launches()
    decode = final_decode_launches("pallas")
    want = {k: v + 5 * decode.get(k, 0) for k, v in main_path["launches"].items()}
    if counts != want:
        die(f"phase 10 (a): launches {counts}, expected phase 4's (pallas, pallas) and five "
            f"eval decodes {want}")
    reader = read_run(log_a, "(a)", FLAGSHIP)
    steps = list(range(20))
    for label, df in (("losses/r_loss", reader.r_loss_scaled),
                      ("losses/kl_loss", reader.kl_loss_scaled),
                      ("losses/expelbo_f", reader.expelbo_f_loss_scaled),
                      ("r_loss_unscaled", reader.r_loss), ("kl_loss_unscaled", reader.kl_loss),
                      ("lossE", reader.loss_e), ("lossD", reader.loss_d),
                      ("diff_kl", reader.diff_kl),
                      ("fc_grad_norm", reader.base_event.get_df("fc_grad_norm"))):
        check_steps("(a)", label, df, steps)
    check_steps("(a)", "perf/images_per_sec", reader.base_event.get_df("perf/images_per_sec"),
                [0])
    if [im.step for im in reader.reconstructions] != [0, 10, 20]:
        die(f"phase 10 (a): image grids at {[im.step for im in reader.reconstructions]}")
    grid = reader.last_reconstruction
    hparams, metrics = reader.hparams
    if hparams["solver"].string_value != "intro_tc" or sorted(metrics) != [
            "loss_dec", "loss_enc", "loss_kl", "loss_rec"]:
        die(f"phase 10 (a): hparams {dict(hparams)}, metrics {metrics}")
    if devices != {"cuda"}:
        die(f"phase 10 (a): eval-mode encodes on {devices}")
    out["a"] = {"heavy_s": heavy_seconds(stats, 2), "drain_ms": drain_ms(stats),
                "drains": stats["flush"][1]}
    print(f"phase 10 (a): the flagship as shipped (writer on), tc and conv pallas, on "
          f"ukiyo_e64: 20 finite steps; launches = phase 4's (pallas, pallas) + 5 eval decodes; "
          f"tb_reader read 9 scalar tags x 20 steps, img/s, the grid at 0, 10, 20 "
          f"({grid.size[0]}x{grid.size[1]} px) and the hparams; "
          f"{images_per_second(state, MAIN_B):.1f} img/s (steps 5-20) on {card}")
    del state

    # (b)
    dsprites_root = os.path.join(work, "dsprites_grid")
    os.makedirs(dsprites_root)
    t0 = time.perf_counter()
    write_dsprites_grid(dsprites_root)
    grid_s = time.perf_counter() - t0
    log_b = os.path.join(work, "runs_b")
    update = {"dataset": "dsprites_small", "data_root": dsprites_root, "num_epochs": 1,
              "tc_impl": "pallas", "conv_impl": "pallas",
              "test_iter": OBS_TEST_ITER["tc_dsprites"], "log_dir": os.path.join(log_b, "tb")}
    reset_all_launches()
    state, lines, stats, devices = observed_cli(TC_DSPRITES, update, "phase 10 (b)", 112)
    counts = all_launches()
    if not counts["tc_fwd"] == counts["tc_bwd_dz"] == counts["tc_bwd_dmu"] == 112:
        die(f"phase 10 (b): TC launches {counts}, expected 112 each")
    if devices != {"cuda"}:
        die(f"phase 10 (b): eval-mode encodes on {devices}")
    reader = read_run(log_b, "(b)", TC_DSPRITES)
    heavy = [0, OBS_TEST_ITER["tc_dsprites"]]
    check_steps("(b)", "mig_score", reader.mig_score, heavy)
    check_steps("(b)", "mod_expl/modularity_score", reader.modularity_score, heavy)
    check_steps("(b)", "losses/r_loss", reader.r_loss_scaled, list(range(112)))
    run = reader.run_path
    failed = {w: [line for line in lines if line.startswith(f"disentanglement metric {w} ")]
              for w in ("write_mig_score", *SKLEARN_SCORES)}
    if failed["write_mig_score"]:
        die(f"phase 10 (b): {failed['write_mig_score']}")
    sklearn_missing = []
    for w in SKLEARN_SCORES:
        written = os.path.isdir(os.path.join(run, SKLEARN_SUBRUN[w]))
        if written and not failed[w]:
            continue
        if written or len(failed[w]) != 2 or not all(
                "ModuleNotFoundError" in f and "sklearn" in f for f in failed[w]):
            die(f"phase 10 (b): {w}: written {written}, failures {failed[w]}")
        sklearn_missing.append(w)
    out["b"] = {"heavy_s": heavy_seconds(stats, 2), "drain_ms": drain_ms(stats),
                "drains": stats["flush"][1]}
    print(f"phase 10 (b): tc_dsprites (writer on), tc and conv pallas, on dsprites_small "
          f"(the full grid written in {grid_s:.1f} s): 112 finite steps, 112 launches of each "
          f"TC kernel; MIG and modularity at {heavy}; sklearn-backed scores "
          + ("failed with ModuleNotFoundError for sklearn: " + ", ".join(sklearn_missing)
             if sklearn_missing else "written") + "; every eval-mode encode on the card; "
          f"{images_per_second(state, MAIN_B):.1f} img/s (steps 5-112) on {card}")
    del state

    # (c)
    sd = {}
    rng = np.random.RandomState(0)
    for k, v in inception.InceptionV3Features().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            sd[k] = torch.from_numpy((rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:])))
                                     .astype(np.float32))
        elif k.endswith(("bn.weight", "running_var")):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        elif k.endswith(("bn.bias", "running_mean")):
            sd[k] = torch.from_numpy(rng.uniform(-0.2, 0.2, shape).astype(np.float32))
        else:
            sd[k] = v
    weights = os.path.join(work, "inception_v3.pth")
    torch.save(sd, weights)
    checkpoint, = os.listdir(saves_a)
    saved_env = os.environ.get(inception.WEIGHTS_ENV)
    os.environ[inception.WEIGHTS_ENV] = weights
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            scores = evaluate.main(["--checkpoint", os.path.join(saves_a, checkpoint),
                                    "--dataset", "ukiyo_e64", "--data-root", ukiyo_root,
                                    "--arch", "conv", "--z-dim", str(Z_DIM), "--fid"])
    finally:
        if saved_env is None:
            del os.environ[inception.WEIGHTS_ENV]
        else:
            os.environ[inception.WEIGHTS_ENV] = saved_env
    eval_s = time.perf_counter() - t0
    fids = (scores.get("fid_inception_pool3"), scores.get("fid_encoder_features"))
    if not all(isinstance(f, float) and math.isfinite(f) and f >= 0 for f in fids):
        die(f"phase 10 (c): evaluate --fid gave {scores}")
    if "no ground-truth factors" not in scores.get("disentanglement", ""):
        die(f"phase 10 (c): evaluate on ukiyo_e64 gave {scores}")

    dev = torch.device("cuda", 0)
    model = inception.load_inception_weights(inception.InceptionV3Features(), weights).eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        want = model(x).numpy()
    fn = inception.inception_feature_fn(weights, device=dev)
    got = fn(x.permute(0, 2, 3, 1).numpy())
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max()):
        die(f"phase 10 (c): Inception on the card vs the CPU: max abs diff {err!r}")
    images = np.random.RandomState(2).rand(INCEPTION_IMAGES, 64, 64, 3).astype(np.float32)
    fn(images[:MAIN_B])  # warm-up: cuDNN's algorithms for the batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, INCEPTION_IMAGES, MAIN_B):
        fn(images[i:i + MAIN_B])
    inception_rate = INCEPTION_IMAGES / (time.perf_counter() - t0)
    out["c"] = {"eval_s": eval_s, "inception_img_s": inception_rate}
    print(f"phase 10 (c): evaluate --fid on (a)'s checkpoint in {eval_s:.1f} s: FID pool3 "
          f"{fids[0]} (random Inception weights), encoder FID {fids[1]}; Inception on the card "
          f"vs the CPU, 4 images 64 px: max abs diff {err:.3g} (largest feature "
          f"{np.abs(want).max():.3g}); Inception pool3 {inception_rate:.1f} img/s (batch 64, "
          f"64 px resized to 299, fp32 TF32 off) on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the rest of the solver surface
# ---------------------------------------------------------------------------

REMAT_MODES = (False, "block", "pass")
REMAT_BATCHES = (MAIN_B, 256)
# steps a remat run: a graphed step's 3 eager steps and its capture, then
# 3 profiled replays (at batch 256 the loader's epochs run on: 5 steps each)
SURFACE_STEPS = 7


@contextlib.contextmanager
def cudnn_deterministic():
    """Deterministic cuDNN algorithms, chosen without autotuning, so that a
    recomputed forward takes the algorithm and the bits of the first."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def seeded_flips(seed: int):
    """Ukiyo-E datasets built in the block draw their random flips from a
    RandomState seeded with ``seed`` (the dataset's own is unseeded, as in
    the JAX package), so that two runs see the same batches."""
    import numpy as np

    from intro_tc_vae_tpu_torch.data import datasets

    init = datasets.UkiyoE.__init__

    def seeded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._rng = np.random.RandomState(seed)

    datasets.UkiyoE.__init__ = seeded
    try:
        yield
    finally:
        datasets.UkiyoE.__init__ = init


def trainer_setup(update: dict, steps: int, graph=None):
    """The flagship through the trainer's own ``setup`` (seed, model,
    optimizers, loader, solver; the step graphed or not as ``graph`` says,
    by the trainer's rule when None) and the first ``steps`` batches of its
    loader (epoch after epoch), on the card."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.solvers.base import normalize_input
    from intro_tc_vae_tpu_torch.train import setup

    run = setup(load_config(FLAGSHIP, {"dataset": "synthetic", "use_tensorboard": False,
                                       **update}), graph=graph)
    run.state.model.train()
    batches = []
    while len(batches) < steps:
        with contextlib.closing(iter(run.loader)) as epoch:
            batches.extend(normalize_input(b) for b in epoch)
    return run, batches[:steps]


# Bytes a block of the caching allocator's large pool (requests over 1
# MiB) may hold beyond its rounded request: a cached block is handed out
# whole unless what would remain is more than 1 MiB (kSmallSize). Small
# blocks are split down to their 512-byte rounding.
LARGE_BLOCK_SLACK = 2 ** 20


def graph_static_bytes(graphed) -> int:
    """What a graphed step holds beyond an eager one: its static batch,
    noise and metrics row, each rounded to the allocator's 512 bytes."""
    tensors = [graphed._batch, *graphed._noise.values(), graphed._out]
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for t in tensors if t is not None)


def warm_workspaces() -> int:
    """Matrix products (cuBLAS's and cuBLASLt's, bf16 and fp32), forward
    and backward, on the current stream and on the stream every
    ``torch.cuda.graph`` captures on by default, then one throwaway
    capture. PyTorch gives each (thread, stream) that first runs a product
    its own cuBLAS and cuBLASLt workspaces and keeps them for the process's
    life, and a backward runs on autograd's own thread; without this, the
    first run in a process to reach a stream would leave them behind.
    Returns what it left allocated: the workspaces the first time in a
    process, 0 after."""
    import gc

    import torch

    x = [torch.ones(64, 64, device="cuda", dtype=dt, requires_grad=True)
         for dt in (torch.bfloat16, torch.float32)]
    graph = torch.cuda.CUDAGraph()
    capture = torch.cuda.graph(graph)

    def products(backward: bool):
        for t in x:
            y = torch.mm(t, t) + torch.addmm(t[0], t, t)
            if backward:
                y.sum().backward()

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    products(True)
    capture.capture_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture.capture_stream):
        products(True)
    torch.cuda.synchronize()
    with torch.no_grad(), capture:
        products(False)
    del graph, capture, x
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before


def memory_of(fn) -> dict:
    """``fn()``'s dict (it builds its run, steps it and lets it go) with the
    run's device memory: ``peak_bytes`` (max_memory_allocated since the
    last reset, which ``fn`` makes after its set-up), ``large_blocks_peak``
    (the most large-pool blocks live at once) and ``left_bytes`` (what is
    still allocated once the run is gone, against before it). The
    streams' matrix-product workspaces are allocated first
    (``warm_workspaces``), so what a run leaves does not depend on whether
    an earlier phase has run a product or captured."""
    import gc

    import torch

    warm_workspaces()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = fn()
    gc.collect()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    out.update(peak_bytes=stats["allocated_bytes.all.peak"],
               large_blocks_peak=stats["allocation.large_pool.peak"],
               left_bytes=torch.cuda.memory_allocated() - before)
    return out


def memory_gate(phase: str, label: str, eager: dict, graphed: dict, card: str) -> None:
    """Fail the phase when the graphed run's peak exceeds the eager run's
    (same configuration, same batches, run just before it) by more than
    what a graph must hold: its static buffers (``graph_static_bytes``)
    plus the allocator's fragmentation, at most LARGE_BLOCK_SLACK for each
    large-pool block live at the graphed peak (the graph's private pool
    hands out and splits blocks by the same rules as the default pool, so
    one run may round a large block up by as much as the other rounds it
    down); or when the graphed run leaves more than its static buffers
    allocated once it is gone (no per-stream workspace, no pool: the
    workspaces of the current and the capture stream were allocated
    before either run, by ``memory_of``)."""
    mib = 2 ** 20
    over = graphed["peak_bytes"] - eager["peak_bytes"]
    frag = LARGE_BLOCK_SLACK * graphed["large_blocks_peak"]
    bound = graphed["static_bytes"] + frag
    print(f"{phase}: {label}: peak device memory eager {eager['peak_bytes'] / mib:,.1f} MiB, "
          f"graphed {graphed['peak_bytes'] / mib:,.1f} MiB ({over / mib:+,.1f}; bound "
          f"{bound / mib:,.1f} = static buffers {graphed['static_bytes'] / mib:,.2f} + "
          f"{graphed['large_blocks_peak']} large blocks x 1 MiB); left allocated after the "
          f"run: eager {eager['left_bytes'] / mib:,.2f}, graphed "
          f"{graphed['left_bytes'] / mib:,.2f} MiB on {card}")
    if over > bound:
        die(f"{phase}: {label}: the graphed peak exceeds the eager peak by "
            f"{over / mib:,.1f} MiB, over the bound of {bound / mib:,.1f} MiB")
    if graphed["left_bytes"] > graphed["static_bytes"]:
        die(f"{phase}: {label}: the graphed run left {graphed['left_bytes'] / mib:,.2f} MiB "
            f"allocated once it was gone")


def profiled_run(label: str, solver, state, batches: list, active: int = 3,
                 phase: str = "phase 11") -> dict:
    """``solver``'s steps on ``batches``, the last ``active`` under
    torch.profiler (the steps before them unprofiled: a graphed step warms
    up and captures there, never in the window): device ms per step (the
    kernels' and copies' device time), peak device memory over the steps
    (``max_memory_allocated``), the launches of phase E and phase D, every
    step's metrics and the final state dict on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    graphed = solver.graphed
    if graphed is not None and len(batches) - active <= graphed.warmup:
        die(f"{phase}: {label}: {len(batches)} steps leave the capture in the profiled window")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    metrics = []

    def step(batch):
        _, m = solver.train_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()

    with launches_per_phase() as (phase_e, phase_d):
        for batch in batches[:-active]:
            step(batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for batch in batches[-active:]:
                step(batch)
    if graphed is not None and graphed.captures != 1:
        die(f"{phase}: {label}: {graphed.captures} captures, expected 1")
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation and not e.key.startswith("ProfilerStep"))
    if device_us <= 0:
        die(f"{phase}: {label}: the profiler recorded no device time")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            die(f"{phase}: {label}: non-finite metrics {m}")
    return {"device_ms": device_us / active / 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "static_bytes": graph_static_bytes(graphed) if graphed is not None else 0,
            "phase_e": dict(phase_e), "phase_d": dict(phase_d), "metrics": metrics,
            "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def remat_runs(steps: int) -> dict:
    """Phase 11 (b): the flagship (tc and conv 'pallas') in every remat
    mode at every batch of REMAT_BATCHES, eager and then graphed, each from
    the same weights, the same generator seed and the same batches (one
    trainer set-up at the largest batch; a smaller batch is the first rows
    of each): the models' ``remat`` for "block", the solver's
    ``remat_passes`` for "pass", fresh optimizers for every run
    (``build_solver``, as ``setup`` builds it); {(batch, mode, graphed):
    ``profiled_run``'s dict with ``memory_of``'s figures}."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.train import build_solver

    import gc

    base = {"tc_impl": "pallas", "conv_impl": "pallas"}
    run, batches = trainer_setup({**base, "batch_size": max(REMAT_BATCHES)}, steps)
    model = run.state.model
    init = {k: v.clone() for k, v in model.state_dict().items()}
    del run.state, run.solver  # their optimizers hold no state yet

    def one(b: int, mode, graph: bool) -> dict:
        model.load_state_dict(init)
        model.encoder.remat = model.decoder.remat = mode in (True, "block")
        config = load_config(FLAGSHIP, {"dataset": "synthetic", **base, "batch_size": b,
                                        "remat": mode})
        solver = build_solver(config, run.loader.dataset, model.encoder, model.decoder,
                              run.mesh, graph=graph)
        return profiled_run(f"batch {b} remat {mode!r}", solver, solver.init_state(run.seed),
                            [x[:b] for x in batches])

    out = {}
    for b in REMAT_BATCHES:
        for mode in REMAT_MODES:
            for graph in (False, True):
                # the last run's optimizer states go before the peak is reset
                gc.collect()
                out[(b, mode, graph)] = memory_of(lambda: one(b, mode, graph))
    return out


def phase_solver_surface(card: str) -> dict:
    """Phase 11: the rest of the solver surface on the card, each path
    driven with the launch counters set to 0 just before it.
    (a) The flagship recipe with arch 'inception', tc and conv 'pallas',
    through the CLI (20 steps): finite losses; the TC kernels launched
    3 + 2 calls x 3 kernels a step and no conv kernel (the block's convs
    are 1x1); its device ms per step (``profiled_run``) and host img/s;
    one fp32 step with the TC kernels against the plain TC in float64 at
    phase 5's gate (metrics rtol 1e-4, updated params atol 1e-5).
    (b) remat false, "block" and "pass" on the flagship (tc and conv
    'pallas') from one trainer set-up (``remat_runs``), SURFACE_STEPS steps
    each at batch 64 and 256, eager and then graphed, cuDNN deterministic:
    the launches of each phase equal to ``expected_intro_launches``;
    metrics, parameters and BatchNorm statistics of "block" and "pass"
    bit-equal to remat false's, graphed metrics to eager's; peak device
    memory and device ms per step of each, the graphed peak held to the
    eager one by ``memory_gate``.
    (c) scan_steps 4 against 1 on the flagship config on an ARC Ukiyo-E
    layout (``write_ukiyo``) with the device cache engaged, through the
    CLI, cuDNN deterministic, the flips seeded (``seeded_flips``): the 20
    steps' metrics and the final parameters bit-equal; img/s of each.
    (d) kl_kind 'tc_full' (intro_tc) and tc_sampling 'weighted' (tc
    'xla') on the same layout, writer on, one step each through the
    trainer's setup: finite; the tc_decomp group read back through the
    port's tb_reader."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_phase11_")
    try:
        return solver_surface(card, work)
    finally:
        shutil.rmtree(work)


def rate_after(state, skip: int) -> float:
    """Host-clock img/s over the steps after the first ``skip``: with
    ``skip`` a multiple of scan_steps, whole calls only (a call's seconds
    are split evenly over its steps, so a partial call would carry a share
    of the first call's warm-up)."""
    steady = state.history[skip:]
    return MAIN_B * len(steady) / sum(r["seconds"] for r in steady)


def solver_surface(card: str, work: str) -> dict:
    """Phase 11's (a)-(d) in ``work``; returns their measurements."""
    import shutil

    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS
    from intro_tc_vae_tpu_torch.train import images_per_second

    out = {}
    saves = os.path.join(work, "saves")
    t0 = time.perf_counter()
    # (a) the inception arch
    inception = {"dataset": "synthetic", "arch": "inception", "tc_impl": "pallas",
                 "conv_impl": "pallas", "num_epochs": 1, "use_tensorboard": False,
                 "checkpoint_dir": saves}
    reset_all_launches()
    with launches_per_phase() as (phase_e, phase_d):
        state = run_cli(FLAGSHIP, inception, "phase 11 (a)")
    counts = all_launches()
    # 1x1 convs: none routes
    want_e, want_d = expected_intro_launches("pallas", "xla", bn=bn_layers("inception"))
    for label, got, want in (("phase E", phase_e, {k: 20 * v for k, v in want_e.items()}),
                             ("phase D", phase_d, {k: 20 * v for k, v in want_d.items()}),
                             ("total", counts, {k: 20 * (want_e[k] + want_d[k])
                                                for k in want_e})):
        if got != want:
            die(f"phase 11 (a): {label} launches {got}, expected {want}")
    rate = images_per_second(state, MAIN_B)
    del state
    shutil.rmtree(saves, ignore_errors=True)  # the next run's saves
    run, batches = trainer_setup({"arch": "inception", "tc_impl": "pallas",
                                  "conv_impl": "pallas"}, SURFACE_STEPS)
    profiled = profiled_run("inception", run.solver, run.state, batches)
    del run, batches
    out["inception"] = {"img_s": rate, "device_ms": profiled["device_ms"]}

    cfg = load_config(FLAGSHIP, {"dataset": "synthetic", "precision": "fp32",
                                 "arch": "inception"})
    ds, image_size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch="inception", cdim=cdim, zdim=cfg.z_dim, channels=channels,
              image_size=image_size, compute_dtype=torch.float32)
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).state_dict()
    dev = torch.device("cuda", 0)
    batch = torch.from_numpy(ds.get_batch(np.arange(MAIN_B)).transpose(0, 3, 1, 2).copy())
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = {k: torch.randn((MAIN_B, cfg.z_dim), generator=gen, device=dev)
             for k in NOISE_KEYS}
    with fp32_exact():
        m_k, p_k = train_one_step(dev, cfg, ds, kw, init, batch, noise, "pallas")
        with plain_tc_in_float64():
            m_x, p_x = train_one_step(dev, cfg, ds, kw, init, batch, noise, "xla")
    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    for name in names:
        if not math.isclose(m_k[name], m_x[name], rel_tol=RTOL, abs_tol=1e-30):
            die(f"phase 11 (a): {name} pallas {m_k[name]!r} vs float64 plain {m_x[name]!r}")
    worst, n_over = params_diff(p_k, p_x)
    if n_over:
        die(f"phase 11 (a): updated params differ by up to {worst!r} ({n_over} over {ATOL})")
    print(f"phase 11 (a): inception arch, tc and conv pallas: 20 finite steps; launches a step "
          f"phase E {dict((k, v // 20) for k, v in phase_e.items() if v)}, phase D "
          f"{dict((k, v // 20) for k, v in phase_d.items() if v)}, no conv kernel; one fp32 "
          f"step with the TC kernels vs the float64 plain TC: metrics within rtol 1e-4, "
          f"updated params max abs diff {worst:.3g} (atol 1e-5); {rate:.1f} img/s (steps "
          f"5-20, host clock), {profiled['device_ms']:.2f} device ms/step (bf16, batch 64) "
          f"on {card}")

    out["seconds"] = {"a": time.perf_counter() - t0}
    # (b) remat
    with cudnn_deterministic():
        remat = remat_runs(SURFACE_STEPS)
    for (b, mode, graph), r in remat.items():
        if not graph:
            continue
        memory_gate("phase 11 (b)", f"batch {b}, remat {mode!r}", remat[(b, mode, False)], r,
                    card)
        if b == MAIN_B:
            want_e, want_d = expected_intro_launches("pallas", "pallas", mode)
            for label, got, want in (("phase E", r["phase_e"], want_e),
                                     ("phase D", r["phase_d"], want_d)):
                want = {k: SURFACE_STEPS * v for k, v in want.items()}
                if got != want:
                    die(f"phase 11 (b): remat {mode!r}: {label} launches {got}, "
                        f"expected {want}")
        if r["metrics"] != remat[(b, mode, False)]["metrics"]:
            die(f"phase 11 (b): batch {b}: remat {mode!r}: graphed metrics differ from eager")
        base = remat[(b, False, True)]
        if r["metrics"] != base["metrics"] or any(
                not torch.equal(v, base["state"][k]) for k, v in r["state"].items()):
            die(f"phase 11 (b): batch {b}: remat {mode!r} differs from remat false "
                "(metrics, parameters or BatchNorm statistics)")
    table = {f"batch {b}": {str(mode): {
        "peak_MiB": remat[(b, mode, True)]["peak_bytes"] / 2**20,
        "eager_peak_MiB": remat[(b, mode, False)]["peak_bytes"] / 2**20,
        "device_ms": remat[(b, mode, True)]["device_ms"],
        "eager_device_ms": remat[(b, mode, False)]["device_ms"]}
        for mode in REMAT_MODES} for b in REMAT_BATCHES}
    out["remat"] = table
    print(f"phase 11 (b): remat false / block / pass, flagship, tc and conv pallas, "
          f"{SURFACE_STEPS} steps each, cuDNN deterministic: launches per phase equal the "
          f"derived counts (recompute adds 6 conv3x3_fwd_wgmma + 6 conv3x3_pack_w a phase); "
          f"block and pass bit-equal to false (metrics, parameters, BatchNorm statistics) at "
          f"batch 64 and 256")
    print("phase 11 (b): peak device MiB and device ms/step "
          + json.dumps({b: {m: {k: round(v, 2) for k, v in d.items()} for m, d in t.items()}
                        for b, t in table.items()}) + f" on {card}")

    out["seconds"]["b"] = time.perf_counter() - t0 - sum(out["seconds"].values())
    # (c) scan_steps
    ukiyo = os.path.join(work, "ukiyo")
    write_ukiyo(ukiyo)
    scan = {}
    with cudnn_deterministic():
        for k in (1, 4):
            with seeded_flips(DATA_SEED):
                state = run_cli(FLAGSHIP, {
                    "data_root": ukiyo, "tc_impl": "pallas", "conv_impl": "pallas",
                    "num_epochs": 1, "use_tensorboard": False, "device_cache": "force",
                    "scan_steps": k, "checkpoint_dir": saves}, f"phase 11 (c) scan_steps {k}")
            scan[k] = (rate_after(state, 4),
                       [{n: v for n, v in r.items() if n not in ("seconds",)}
                        for r in state.history],
                       {n: v.detach().cpu() for n, v in state.model.state_dict().items()})
            del state
            shutil.rmtree(saves, ignore_errors=True)  # the next run's saves
    if scan[4][1] != scan[1][1] or any(not torch.equal(v, scan[1][2][n])
                                       for n, v in scan[4][2].items()):
        die("phase 11 (c): scan_steps 4 differs from scan_steps 1 (metrics or parameters)")
    out["scan"] = {k: v[0] for k, v in scan.items()}
    print(f"phase 11 (c): scan_steps 4 vs 1, the flagship on ukiyo_e64 with the device cache, "
          f"20 steps through the CLI, cuDNN deterministic: every step's metrics and the final "
          f"parameters bit-equal; img/s (steps 5-20, host clock) 1: {scan[1][0]:.1f}, 4: "
          f"{scan[4][0]:.1f} on {card}")

    out["seconds"]["c"] = time.perf_counter() - t0 - sum(out["seconds"].values())
    # (d) tc_full and weighted, one step each, the writer on
    for label, update in (("tc_full", {"kl_kind": "tc_full", "tc_impl": "pallas"}),
                          ("weighted", {"tc_sampling": "weighted", "tc_impl": "xla"})):
        log_root = os.path.join(work, f"runs_{label}")
        values = one_logged_step({"data_root": ukiyo, "conv_impl": "pallas",
                                  "use_tensorboard": True,
                                  "log_dir": os.path.join(log_root, "tb"), **update})
        if label == "tc_full":
            reader = read_run(log_root, "(d)", FLAGSHIP)
            for tag, df in (("mi", reader.tc_decomp_mi), ("tc", reader.tc_decomp_tc),
                            ("kl", reader.tc_decomp_kl)):
                got = list(df["value"])
                if list(df["step"]) != [0] or not math.isclose(
                        got[0], values[f"tc_decomp/{tag}"], rel_tol=1e-6):
                    die(f"phase 11 (d): tc_decomp/{tag} read back {list(df['step'])} {got}, "
                        f"the step gave {values[f'tc_decomp/{tag}']}")
        print(f"phase 11 (d): {label}: one step, finite (lossE {values['lossE']:.6g}, lossD "
              f"{values['lossD']:.6g})"
              + ("; tc_decomp mi/tc/kl read back through tb_reader at step 0 "
                 + json.dumps({k: values[f"tc_decomp/{k}"] for k in ("mi", "tc", "kl")})
                 if label == "tc_full" else ""))
    out["seconds"]["d"] = time.perf_counter() - t0 - sum(out["seconds"].values())
    print("phase 11: seconds of (a)-(d) "
          + json.dumps({k: round(v, 1) for k, v in out["seconds"].items()}))
    return out


def one_logged_step(update: dict) -> dict:
    """One flagship step through the trainer's setup with the writer on,
    drained and flushed: its metrics on the host (finite, or the phase fails)."""
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.solvers.base import normalize_input
    from intro_tc_vae_tpu_torch.train import setup
    from intro_tc_vae_tpu_torch.utils.writer import SingletonWriter

    run = setup(load_config(FLAGSHIP, update))
    try:
        run.state.model.train()
        with contextlib.closing(iter(run.loader)) as batches:
            batch = normalize_input(next(batches))
        run.solver.train_step(run.state, batch)
        (values, step), = run.solver.flush_writes()
        if step != 1 or not all(math.isfinite(v) for v in values.values()):
            die(f"phase 11 (d): {update}: step {step} metrics {values}")
    finally:
        if run.writer is not None:
            run.writer.close()
        SingletonWriter().writer = None
    return values


def start():
    """Phases 1 and 2: the device, then every kernel library built from
    this checkout's sources, one nvcc each, started together. Returns
    (device name, nvidia-smi's name and power limit)."""
    try:
        import torch
    except ImportError:
        die("PyTorch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    try:
        import intro_tc_vae_tpu_torch
    except ImportError:
        die("intro_tc_vae_tpu_torch not found: run from the root of a checkout")
    if os.path.dirname(os.path.dirname(os.path.abspath(intro_tc_vae_tpu_torch.__file__))) != HERE:
        die(f"intro_tc_vae_tpu_torch imported from {intro_tc_vae_tpu_torch.__file__}, "
            "not from this checkout")

    # ---- phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1: device {name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible")
    print(card)  # nvidia-smi's name, power.limit

    # ---- phase 2: build from the checkout's sources, one nvcc per source
    from concurrent.futures import ThreadPoolExecutor

    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, conv_cuda, cuda_build, tc_cuda
    from intro_tc_vae_tpu_torch.runtime import native

    libraries = ("tc_kernels", "bn_kernels", *conv_cuda.LIBRARIES)  # every source under csrc/
    for path in [cuda_build.library_path(lib) for lib in libraries] + [native.library_path()]:
        if path.exists():
            path.unlink()  # always compile this checkout's source
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        host_build = pool.submit(native.build)  # the data core, g++ (phase 9)
        built = list(pool.map(cuda_build.build, libraries)) + [host_build.result()]
    tc_cuda._library()
    batchnorm_cuda._library()
    for lib in conv_cuda.LIBRARIES:
        conv_cuda._library(lib)
    for path, seconds in built:
        print(f"phase 2: built {os.path.relpath(path, HERE)} in {seconds:.1f} s")
    return name, card


PROFILED_STEPS = 5


@contextlib.contextmanager
def after_each_train_step(fn):
    """Calls ``fn()`` after every ``train_step`` call of the port's solvers
    in the block, an eager step or a graph's replay alike (the package's
    ``VAESolver.train_step`` wrapped; also the package of another
    checkout, as ``loop_times.py --root`` imports it)."""
    from intro_tc_vae_tpu_torch.solvers import base

    original = base.VAESolver.train_step

    def wrapped(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        fn()
        return out

    base.VAESolver.train_step = wrapped
    try:
        yield
    finally:
        base.VAESolver.train_step = original


def profiled_steps(run, wait: int = 13) -> dict:
    """Device microseconds by kernel name over PROFILED_STEPS steady steps
    (after ``wait`` + 1) of ``run()``, a run through the CLI of at least
    ``wait`` + 1 + PROFILED_STEPS steps (20 by default): torch.profiler,
    a step ending where its ``train_step`` call returns (after a sync), so
    a graphed step's capture (its 4th call) falls in the unprofiled
    ``wait``. Kernels and device copies only: a step's annotation spans
    the step. ``--device-time`` and loop_times.py measure a step's device
    time with this."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=wait, warmup=1, active=PROFILED_STEPS)) as prof:
        def step():
            torch.cuda.synchronize()
            prof.step()

        with after_each_train_step(step):
            run()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and not e.key.startswith("ProfilerStep")}


PHASE12_STEPS = 8


def bf16_rounded_layers(net) -> int:
    """Operations of an Encoder or Decoder whose result is rounded to bf16:
    every conv and dense layer, every BatchNorm and the leaky ReLU after it,
    the encoder's average pools (as many as stages) and the leaky ReLU after
    the decoder's dense layer (the count of tests/_torch_bf16.py)."""
    from torch import nn

    from intro_tc_vae_tpu_torch.models.blocks import GroupedBatchNorm

    n = sum(1 if isinstance(m, (nn.Conv2d, nn.Linear)) else 2
            for m in net.modules() if isinstance(m, (nn.Conv2d, nn.Linear, GroupedBatchNorm)))
    return n + (len(net.stages) if isinstance(net.fc, nn.Linear) else 1)


def phase_48px(card: str) -> dict:
    """Phase 12: the flagship recipe at 48 px, whose res_in_48 convs run
    the ragged entry points at [128, 64, 48, 48]: launches, a step held to
    the cuDNN arm, device ms/step of both arms."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import Synthetic, load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.ops import conv
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS
    from intro_tc_vae_tpu_torch.train import build_solver
    from intro_tc_vae_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    size = 48
    if conv.kernel_body(CONV_48, torch.bfloat16) != "ragged":
        die(f"phase 12: {CONV_48} does not take the ragged entry points")
    configs = {impl: load_config(FLAGSHIP, {"dataset": "synthetic", "tc_impl": "pallas",
                                            "conv_impl": impl, "use_tensorboard": False})
               for impl in ("pallas", "xla")}
    cfg = configs["pallas"]
    _, _, channels, cdim = load_dataset(cfg.dataset)
    ds = Synthetic(image_size=size, cdim=cdim)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=tuple(channels),
              image_size=size, compute_dtype=torch.bfloat16)
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).state_dict()
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(ds.get_batch(rng.randint(0, len(ds), MAIN_B))
                                .transpose(0, 3, 1, 2).copy()).to(dev)
               for _ in range(PHASE12_STEPS)]
    mesh = make_mesh(1, device=dev)

    runs = {}
    for impl, config in configs.items():
        model = SoftIntroVAE(Encoder(**kw, conv_impl=impl), Decoder(**kw, conv_impl=impl))
        model.load_state_dict(init)
        model.to(dev).train()
        solver = build_solver(config, ds, model.encoder, model.decoder, mesh)
        runs[impl] = profiled_run(f"48 px, conv {impl}", solver, solver.init_state(0),
                                  batches, phase="phase 12")
        want_e, want_d = expected_intro_launches("pallas", impl, routed=2, body="ragged")
        for label, got, want in (("phase E", runs[impl]["phase_e"], want_e),
                                 ("phase D", runs[impl]["phase_d"], want_d)):
            want = {k: PHASE12_STEPS * v for k, v in want.items()}
            if got != want:
                die(f"phase 12: 48 px, conv {impl}: {label} launches {got}, expected {want}")
        print(f"phase 12: 48 px, conv {impl}: {PHASE12_STEPS} steps, finite metrics; launches "
              f"phase E {runs[impl]['phase_e']}, phase D {runs[impl]['phase_d']} (exact); "
              f"device {runs[impl]['device_ms']:.3f} ms/step on {card}")

    # one step of each arm from the same weights, batch and noise
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = {k: torch.randn((MAIN_B, cfg.z_dim), generator=gen, device=dev)
             for k in NOISE_KEYS}
    steps = {impl: train_one_step(dev, cfg, ds, kw, init, batches[0], noise, "pallas", impl)
             for impl in configs}
    (m_k, p_k), (m_x, p_x) = steps["pallas"], steps["xla"]
    layers = bf16_rounded_layers(Encoder(**kw)) + bf16_rounded_layers(Decoder(**kw))
    rel = math.sqrt(layers) * 2.0 ** -8
    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    worst_rel = max(abs(m_k[n] - m_x[n]) / max(abs(m_k[n]), abs(m_x[n]), 1e-30)
                    for n in names)
    if not all(math.isclose(m_k[n], m_x[n], rel_tol=rel, abs_tol=1e-30) for n in names):
        die(f"phase 12: conv pallas vs xla metrics differ by {worst_rel:.3g} relative > "
            f"{rel:.3g}: " + json.dumps({n: [m_k[n], m_x[n]] for n in names}))
    # parameters: Adam's first update is at most lr an entry, so two steps
    # differ by at most 2 lr, plus the fp32 rounding of p - update in each
    # (half a spacing of the largest |p| each); BatchNorm's running
    # statistics move with the batch's, which the bf16 convs round apart:
    # each buffer within sqrt(L) 2^-8 of its largest entry
    trained = {k for k, _ in SoftIntroVAE(Encoder(**kw), Decoder(**kw)).named_parameters()}
    worst, _ = params_diff({k: p_k[k] for k in trained}, {k: p_x[k] for k in trained})
    p_max = max(float(np.abs(p_x[k]).max()) for k in trained)
    p_bound = 2 * LR + float(np.spacing(np.float32(p_max)))
    if not worst <= p_bound:
        die(f"phase 12: conv pallas vs xla: updated params differ by {worst!r} > 2 lr + "
            f"spacing({p_max:.3g}) = {p_bound!r}")
    stats_rel = max(float(np.abs(p_k[k] - p_x[k]).max()) / max(float(np.abs(p_x[k]).max()), 1e-30)
                    for k in p_x if k not in trained and p_x[k].dtype.kind == "f")
    if not stats_rel <= rel:
        die(f"phase 12: conv pallas vs xla: BatchNorm statistics differ by {stats_rel:.3g} "
            f"of their largest entry > {rel:.3g}")
    ms = {impl: r["device_ms"] for impl, r in runs.items()}
    print(f"phase 12: one bf16 step at 48 px, conv pallas vs xla: metrics max rel diff "
          f"{worst_rel:.3g} (<= sqrt({layers}) 2^-8 = {rel:.3g}) "
          + json.dumps({n: [m_k[n], m_x[n]] for n in names})
          + f"; updated params max abs diff {worst:.6g} (<= 2 lr + rounding = {p_bound:.6g}); "
          f"BatchNorm "
          f"statistics max diff {stats_rel:.3g} of their largest entry (<= {rel:.3g})")
    print(f"phase 12: device ms/step at 48 px (bf16, batch 64): conv pallas {ms['pallas']:.3f}, "
          f"conv xla {ms['xla']:.3f} on {card}")
    return {"launches": {k: runs["pallas"]["phase_e"][k] + runs["pallas"]["phase_d"][k]
                         for k in runs["pallas"]["phase_e"]},
            "device_ms": ms}


# ---------------------------------------------------------------------------
# phase 13: the model options, the reference-checkpoint loader, the doctor
# ---------------------------------------------------------------------------

PHASE13_STEPS = 10  # an epoch of the cut synthetic set (640 images), batch 64
PACKS = (0, 2, 4)
TILES = (0, 16, 32)
DOCTOR_OVER_BATCH = 4096  # the flagship's estimate at this batch: ~105 GiB


@contextlib.contextmanager
def synthetic_steps(steps: int):
    """The trainer's ``synthetic`` dataset cut to ``steps`` flagship batches
    of 64 (factor grid (steps / 5, 5, 8, 8)), so that one epoch through the
    CLI is ``steps`` steps; the images keep the recipe's 64x64x3."""
    from intro_tc_vae_tpu_torch import train
    from intro_tc_vae_tpu_torch.data import Synthetic

    if steps % 5:
        die(f"synthetic_steps: {steps} is not a multiple of 5")
    load = train.load_dataset

    def cut(name, data_root=None):
        ds, size, channels, cdim = load(name, data_root=data_root)
        if name == "synthetic":
            ds = Synthetic(image_size=size, cdim=cdim, sizes=(steps // 5, 5, 8, 8))
        return ds, size, channels, cdim

    train.load_dataset = cut
    try:
        yield
    finally:
        train.load_dataset = load


def option_run(label: str, update: dict, card: str) -> tuple:
    """PHASE13_STEPS flagship steps (tc 'pallas') through the CLI with the
    model options of ``update``: launches of each phase and of the run
    against ``expected_intro_launches`` (with ``tile_rows`` > 0 no conv
    routes, so none launches, the final decode's included), device ms per
    step over the last PROFILED_STEPS (``profiled_steps``). Returns
    (device ms/step, the final TrainState)."""
    conv_impl = update["conv_impl"]
    routed = 0 if update.get("tile_rows", 0) > 0 else 3
    full = {"dataset": "synthetic", "tc_impl": "pallas", "num_epochs": 1,
            "use_tensorboard": False, **update}
    box = []
    reset_all_launches()
    with synthetic_steps(PHASE13_STEPS), launches_per_phase() as (phase_e, phase_d):
        by_name = profiled_steps(
            lambda: box.append(run_cli(FLAGSHIP, full, label, steps=PHASE13_STEPS)),
            wait=PHASE13_STEPS - PROFILED_STEPS - 1)
    counts = all_launches()
    want_e, want_d = expected_intro_launches("pallas", conv_impl, routed=routed)
    tail = final_decode_launches(conv_impl) if routed else {}
    n = PHASE13_STEPS
    for what, got, want in (("phase E", phase_e, {k: n * v for k, v in want_e.items()}),
                            ("phase D", phase_d, {k: n * v for k, v in want_d.items()}),
                            ("total", counts, {k: n * (want_e[k] + want_d[k]) + tail.get(k, 0)
                                               for k in want_e})):
        if got != want:
            die(f"phase 13: {label}: {what} launches {got}, expected {want}")
    device_ms = sum(by_name.values()) / PROFILED_STEPS / 1e3
    if device_ms <= 0:
        die(f"phase 13: {label}: the profiler recorded no device time")
    conv_launched = sum(v for k, v in counts.items() if k.startswith("conv3x3"))
    print(f"phase 13: {label}: {n} steps through the CLI, finite losses; launches phase E "
          f"{phase_e}, phase D {phase_d} (exact; {conv_launched} conv kernel launches in "
          f"all); device {device_ms:.3f} ms/step on {card}")
    return device_ms, box[0]


def predict_conv_times(dev, card: str) -> dict:
    """cuDNN's time for the decoder's plain 5x5 64 -> 3 predict conv (with
    bias) against the packed form (one-hot weight product, pixel_unshuffle,
    a 3x3 conv, pixel_shuffle) at b = 2 and 4, bf16, at the paired
    decoder's [128, 64, 64, 64]: the forward, and forward plus the backward
    to the input, weight and bias. Library times, recorded for the measured
    ``pack_predict: -1`` (auto) decision (ROADMAP Queue 1 item 1)."""
    import torch

    from intro_tc_vae_tpu_torch.models.blocks import Conv2d, PackedPredictConv

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((2 * MAIN_B, 64, 64, 64), generator=gen, device=dev).to(bf16)
    gy = torch.randn((2 * MAIN_B, 3, 64, 64), generator=gen, device=dev).to(bf16)
    torch.manual_seed(13)
    plain = Conv2d(64, 3, 5, bias=True, compute_dtype=bf16).to(dev)
    forms = {"plain 5x5": plain}
    for b in (2, 4):
        forms[f"packed b={b}"] = PackedPredictConv(64, 3, b, compute_dtype=bf16).to(dev)
        forms[f"packed b={b}"].load_state_dict(plain.state_dict())
    out, ref = {}, None
    for name, m in forms.items():
        with torch.no_grad():
            y = m(x)
            fwd = median_ms(lambda: m(x))
        ref = y if ref is None else ref
        err = float((y.float() - ref.float()).abs().max())
        xr = x.detach().requires_grad_()
        both = median_ms(lambda: torch.autograd.grad(m(xr), (xr, m.weight, m.bias), gy))
        out[name] = {"fwd_ms": fwd, "fwd_bwd_ms": both, "max_abs_diff_vs_plain": err}
        if not err <= 0.05 * float(ref.float().abs().max()):
            die(f"phase 13 (a): {name} differs from the plain predict conv by {err!r}")
    print("phase 13 (a): predict conv 64 -> 3 at [128, 64, 64, 64] bf16, ms (cuDNN under "
          "each form) " + json.dumps({k: {n: round(v, 5) for n, v in r.items()}
                                      for k, r in out.items()}) + f" on {card}")
    return out


def option_steps(dev) -> None:
    """One fp32 step (TF32 off, deterministic cuDNN) of each option against
    the plain model from the same weights, batch and noise, at phase 5
    (b)'s gate (metrics rtol 1e-4, updated params within 2 lr, plus the
    fp32 rounding of p - update as phase 12 allows it: Adam's first update
    is about lr sign(g), so an entry whose gradient changes sign moves by
    2 lr):
    ``pack_predict`` 2 against 0 (conv 'pallas' in both: the routed convs
    run the fp32 kernels), ``tile_rows`` 16 (conv 'pallas', which routes
    nothing) against 0 with conv 'xla'."""
    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers import NOISE_KEYS

    cfg = load_config(FLAGSHIP, {"dataset": "synthetic", "precision": "fp32"})
    ds, image_size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=channels,
              image_size=image_size, compute_dtype=torch.float32)
    torch.manual_seed(0)
    init = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).state_dict()
    batch = torch.from_numpy(ds.get_batch(np.arange(MAIN_B)).transpose(0, 3, 1, 2).copy())
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = {k: torch.randn((MAIN_B, cfg.z_dim), generator=gen, device=dev)
             for k in NOISE_KEYS}
    names = ("lossE", "lossD", "loss_kl", "loss_rec", "expelbo_r", "expelbo_f")
    with fp32_exact():
        for label, base, option in (("pack_predict 2 vs 0", "pallas", {"pack_predict": 2}),
                                    ("tile_rows 16 vs 0 (conv xla)", "xla", {"tile_rows": 16})):
            m_o, p_o = train_one_step(dev, cfg, ds, kw, init, batch, noise, "pallas", "pallas",
                                      option)
            m_b, p_b = train_one_step(dev, cfg, ds, kw, init, batch, noise, "pallas", base)
            for n in names:
                if not math.isclose(m_o[n], m_b[n], rel_tol=RTOL, abs_tol=1e-30):
                    die(f"phase 13: fp32 step {label}: {n} {m_o[n]!r} vs {m_b[n]!r}")
            worst, n_over = params_diff(p_o, p_b)
            p_max = max(float(np.abs(v).max()) for v in p_b.values())
            p_bound = 2 * LR + float(np.spacing(np.float32(p_max)))
            if not worst <= p_bound:
                die(f"phase 13: fp32 step {label}: updated params differ by {worst!r} > 2 lr "
                    f"+ spacing({p_max:.3g}) = {p_bound!r}")
            rel = max(abs(m_o[n] - m_b[n]) / abs(m_b[n]) for n in names)
            print(f"phase 13: one fp32 step (TF32 off), {label}: metrics max rel diff "
                  f"{rel:.3g} (rtol 1e-4); updated params max abs diff {worst:.6g} (<= 2 lr + "
                  f"rounding = {p_bound:.6g}), {n_over} entries over {ATOL}")


def option_clis(path: str, work: str) -> None:
    """(c) ``sample --pack 2`` and ``evaluate --pack 2`` on the flagship
    checkpoint ``path``: the PNG within 2 levels of ``--pack 0``'s (fp32
    decodes, the same products in another order), ``--pack 1`` bit-equal
    to ``--pack 0``; evaluate's FID fakes within 1e-5 of ``--pack 0``'s
    (TF32 off). The CLIs build the stock convs: no hand kernel launches."""
    import numpy as np
    from PIL import Image

    from intro_tc_vae_tpu_torch import evaluate, sample
    from intro_tc_vae_tpu_torch.evaluation import fid

    reset_all_launches()
    argv = ["--checkpoint", path, "--dataset", "synthetic", "--arch", "conv",
            "--z-dim", str(Z_DIM)]
    grids = {p: sample.main([*argv, "--num", "16", "--seed", "3", "--pack", str(p),
                             "--out", os.path.join(work, f"pack{p}.png")]) for p in (0, 1, 2)}
    png = np.asarray(Image.open(os.path.join(work, "pack2.png")))
    levels = int(np.abs(png.astype(int) - grids[0]).max())
    if not (np.array_equal(png, grids[2]) and levels <= 2):
        die(f"phase 13 (c): sample --pack 2 differs from --pack 0 by {levels} levels")
    if not np.array_equal(grids[1], grids[0]):
        die("phase 13 (c): sample --pack 1 differs from --pack 0")

    fakes, encoder_fid = [], fid.encoder_fid

    def spy(solver, state, real, fake, **kw):
        fakes.append(fake)
        return encoder_fid(solver, state, real, fake, **kw)

    fid.encoder_fid = spy
    try:
        scores = [evaluate.main([*argv, "--batch", str(MAIN_B), "--num-samples", "64", "--fid",
                                 "--fid-samples", str(2 * MAIN_B), "--pack", str(p)])
                  for p in (0, 2)]
    finally:
        fid.encoder_fid = encoder_fid
    diff = float(np.abs(fakes[1] - fakes[0]).max())
    if not (diff <= 1e-5 and set(scores[0]) == set(scores[1])
            and math.isfinite(scores[1]["fid_encoder_features"])):
        die(f"phase 13 (c): evaluate --pack 2: fakes differ by {diff!r} from --pack 0's, "
            f"scores {scores[1]}")
    launched = {k: v for k, v in all_launches().items() if v}
    if launched:
        die(f"phase 13 (c): the CLIs launched {launched}")
    print(f"phase 13 (c): sample --pack 2 PNG {png.shape} within {levels} level(s) of "
          f"--pack 0's, --pack 1 bit-equal; evaluate --pack 2 fakes within {diff:.3g} of "
          f"--pack 0's, encoder FID {scores[1]['fid_encoder_features']} vs "
          f"{scores[0]['fid_encoder_features']}; no hand kernel launched")


def reference_checkpoint(dev, path: str, work: str) -> None:
    """(d) The flagship checkpoint ``path`` as the reference writes it: its
    state_dict, a ``num_batches_tracked`` for every BatchNorm and the dead
    ``conv_expand.weight`` of each conv-arch block whose widths differ,
    under "model". ``load_torch_checkpoint`` puts it into a fresh model on
    the card (other initial weights) whose eval-mode decode is bit-equal to
    the source model's; the file with a key removed raises naming it."""
    import torch

    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.models.blocks import ConvolutionalBlock, GroupedBatchNorm
    from intro_tc_vae_tpu_torch.utils import load_model, load_torch_checkpoint

    kw = dict(arch="conv", cdim=3, zdim=Z_DIM, channels=(64, 128, 256, 512), image_size=64,
              compute_dtype=torch.bfloat16)
    src = load_model(SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev), path).eval()
    sd = dict(src.state_dict())
    for name, m in src.named_modules():
        if isinstance(m, GroupedBatchNorm):
            sd[f"{name}.num_batches_tracked"] = torch.tensor(20)
        if isinstance(m, ConvolutionalBlock) and m.conv1.weight.shape[0] != m.conv1.weight.shape[1]:
            o, i = m.conv1.weight.shape[:2]
            sd[f"{name}.conv_expand.weight"] = torch.zeros(o, i, 1, 1, device=dev)
    ref_path = os.path.join(work, "reference.pth")
    torch.save({"epoch": 0, "model": sd}, ref_path)
    torch.manual_seed(5)
    model = load_torch_checkpoint(ref_path, SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev))
    model.eval()
    z = torch.randn((2 * MAIN_B, Z_DIM), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    with torch.no_grad(), cudnn_deterministic():
        want, got = src.decoder(z), model.decoder(z)
    if not torch.equal(want, got):
        die(f"phase 13 (d): the loaded model's decode differs by "
            f"{float((want - got).abs().max())!r}")
    dropped = sorted(k for k in sd if k.endswith("num_batches_tracked") or ".conv_expand." in k)
    gone = dict(sd)
    del gone["decoder.main.res_in_64.bn2.weight"]
    torch.save({"model": gone}, os.path.join(work, "gone.pth"))
    try:
        load_torch_checkpoint(os.path.join(work, "gone.pth"), model)
    except RuntimeError as e:
        if "decoder.main.res_in_64.bn2.weight" not in str(e):
            die(f"phase 13 (d): the missing key's error does not name it: {e}")
    else:
        die("phase 13 (d): a file with a key removed loaded")
    print(f"phase 13 (d): load_torch_checkpoint on a reference-format file ({len(sd)} keys, "
          f"{len(dropped)} of them num_batches_tracked or the dead conv_expand): eval decode "
          f"[{2 * MAIN_B}, 3, 64, 64] bit-equal to the source model's; a file without "
          "decoder.main.res_in_64.bn2.weight raises naming it")


def doctor_on_card(work: str, card: str) -> None:
    """(e) ``python -m intro_tc_vae_tpu_torch.doctor``'s ``main`` on the card:
    the flagship config (synthetic) passes with the activation-memory line
    naming the card; phase 9's dSprites-layout npz (tc_dsprites) and an ARC
    Ukiyo-E layout (64 images) pass; the npz without ``latents_values`` and
    the flagship at batch DOCTOR_OVER_BATCH fail with exit 1. Then the
    doctor's estimate beside ``max_memory_allocated`` over 3 flagship steps
    (tc and conv 'pallas') at batch 64, remat false and "pass", and their
    ratio: the estimate counts activations only."""
    import gc
    import io

    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch import doctor
    from intro_tc_vae_tpu_torch.config import load_config

    name = torch.cuda.get_device_name(0)
    dirs = {"checkpoint_dir": os.path.join(work, "ck"), "log_dir": os.path.join(work, "tb")}
    dsprites, ukiyo, broken = (os.path.join(work, d) for d in ("dsprites", "ukiyo", "broken"))
    for d in (dsprites, ukiyo, broken):
        os.makedirs(d)
    write_dsprites(dsprites)
    write_ukiyo(ukiyo, n_images=64)
    np.savez(os.path.join(broken, DSPRITES_NPZ), imgs=np.zeros((4, 64, 64), np.uint8))

    def run(config: str, update: dict) -> tuple:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = doctor.main(["-f", config, "-u", json.dumps({**dirs, **update})])
        return rc, out.getvalue()

    cases = (("flagship", FLAGSHIP, {"dataset": "synthetic"}, 0, "PASS  activation memory"),
             ("dSprites layout", TC_DSPRITES, {"data_root": dsprites}, 0,
              "PASS  activation memory"),
             ("Ukiyo-E layout", FLAGSHIP, {"data_root": ukiyo}, 0, "PASS  Ukiyo-E decode probe"),
             ("npz without latents_values", TC_DSPRITES, {"data_root": broken}, 1,
              "FAIL  dSprites key 'latents_values'"),
             (f"flagship at batch {DOCTOR_OVER_BATCH}", FLAGSHIP,
              {"dataset": "synthetic", "batch_size": DOCTOR_OVER_BATCH}, 1,
              "FAIL  activation memory"))
    for label, config, update, want_rc, line in cases:
        rc, out = run(config, update)
        memory = [ln for ln in out.splitlines() if "activation memory" in ln]
        if rc != want_rc or line not in out or len(memory) != 1 or name not in memory[0]:
            die(f"phase 13 (e): doctor, {label}: exit {rc} (expected {want_rc}), "
                f"expected '{line}':\n{out}")
        print(f"phase 13 (e): doctor, {label}: exit {rc}; {memory[0].strip()}")

    def three_steps(mode, graph: bool) -> dict:
        run_, batches = trainer_setup({"tc_impl": "pallas", "conv_impl": "pallas",
                                       "remat": mode}, 3, graph=graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for batch in batches:
            _, metrics = run_.solver.train_step(run_.state, batch)
            run_.solver.check_finite(metrics)
        torch.cuda.synchronize()
        graphed = run_.solver.graphed
        return {"static_bytes": graph_static_bytes(graphed) if graphed is not None else 0}

    for mode in (False, "pass"):
        torch.cuda.empty_cache()
        eager, graphed = (memory_of(lambda: three_steps(mode, g)) for g in (False, True))
        memory_gate("phase 13 (e)", f"3 steps at batch {MAIN_B}, remat {mode!r}", eager,
                    graphed, card)
        est, _ = doctor.activation_estimate(
            load_config(FLAGSHIP, {"dataset": "synthetic", "remat": mode}))
        for label, r in (("eager", eager), ("graphed", graphed)):
            peak = r["peak_bytes"]
            print(f"phase 13 (e): batch {MAIN_B}, remat {mode!r}, {label}: doctor estimate "
                  f"{est / 2**20:,.0f} MiB, max_memory_allocated over 3 steps "
                  f"{peak / 2**20:,.0f} MiB, ratio {est / peak:.3f} on {card}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_options(card: str) -> dict:
    """Phase 13: the model options, the reference loader and the doctor at
    the flagship's width (``option_run``, ``predict_conv_times``,
    ``option_steps``, ``option_clis``, ``reference_checkpoint``,
    ``doctor_on_card``), every file in a temporary directory."""
    import shutil
    import tempfile

    import torch

    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    seconds, t0 = {}, time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    try:
        saves = os.path.join(work, "saves")
        ms = {}
        for p in PACKS:
            update = {"conv_impl": "pallas", "pack_predict": p,
                      **({"checkpoint_dir": saves} if p == 0 else {})}
            ms[f"pack_predict {p}"], state = option_run(f"(a) pack_predict {p}", update, card)
            predict = type(state.model.decoder.main["predict"]).__name__
            if predict != ("PackedPredictConv" if p else "Conv2d"):
                die(f"phase 13 (a): pack_predict {p} built a {predict}")
            del state
        for t in TILES:
            update = {"conv_impl": "xla" if t == 0 else "pallas", "tile_rows": t}
            label = f"(b) tile_rows {t}, conv {update['conv_impl']}"
            ms[f"tile_rows {t}"], state = option_run(label, update, card)
            stem = type(state.model.encoder.main["0"]).__name__
            if stem != ("StripTiledConv" if t else "Conv2d"):
                die(f"phase 13 (b): tile_rows {t} built a {stem} stem")
            del state
        lap("(a), (b) CLI runs")
        print(f"phase 13: device ms/step (bf16, batch 64, tc pallas; pack_predict with conv "
              f"pallas, tile_rows 0 with conv xla) "
              + json.dumps({k: round(v, 3) for k, v in ms.items()}) + f" on {card}")
        torch.cuda.empty_cache()
        times = predict_conv_times(dev, card)
        lap("(a) predict conv times")
        option_steps(dev)
        lap("(a), (b) fp32 steps")
        path, = (os.path.join(saves, f) for f in os.listdir(saves))
        option_clis(path, work)
        lap("(c)")
        reference_checkpoint(dev, path, work)
        lap("(d)")
        torch.cuda.empty_cache()
        doctor_on_card(work, card)
        lap("(e)")
    finally:
        shutil.rmtree(work)
    print("phase 13: seconds by part " + json.dumps(seconds))
    return {"device_ms": ms, "predict_conv": times}


TP_UPDATE = {"dataset": "synthetic", "tc_impl": "pallas", "conv_impl": "pallas",
             "num_epochs": 1, "use_tensorboard": False, "resume": None}
TP_GRIDS = {"a": 2, "b": 4}   # ranks of (a) TP2 x DP1 and (b) TP2 x DP2
TP_MODEL = 2
TP_STEPS = 10  # an epoch of the cut synthetic set (640 images), batch 64


def state_bytes(state) -> tuple:
    """(bytes this process holds, bytes of the whole state): parameters,
    BatchNorm statistics and both optimizers' state, counted exactly; a
    leaf sharded over the model axis counts whole as its slice times the
    model axis."""
    import torch

    from intro_tc_vae_tpu_torch.parallel.mesh import sharded_keys

    def nbytes(t):
        return t.numel() * t.element_size()

    cut = {k: m.model_group.size for k, (m, _, _) in sharded_keys(state.model).items()}
    sd = state.model.state_dict()
    local = sum(nbytes(t) for t in sd.values())
    whole = sum(nbytes(t) * cut.get(k, 1) for k, t in sd.items())
    for opt in (state.opt_e, state.opt_d):
        for p, entry in opt.state.items():
            shard = getattr(p, "tp", None)
            for v in entry.values():
                if isinstance(v, torch.Tensor):
                    local += nbytes(v)
                    whole += nbytes(v) * (shard.group.size if shard is not None
                                          and v.shape == p.shape else 1)
    return local, whole


def tp_train(update: dict) -> dict:
    """TP_STEPS flagship steps through the CLI's entry with ``update``,
    every count set to 0 just before and read per phase, the peak device
    memory from the start, device ms/step over the last PROFILED_STEPS
    (``profiled_steps``) and wall ms/step (``images_per_second``), the
    state's bytes, the digest of its replicated leaves and its whole
    (gathered) parameters and statistics on the host."""
    import torch

    from intro_tc_vae_tpu_torch import main as cli_main
    from intro_tc_vae_tpu_torch.ops import tc_cuda
    from intro_tc_vae_tpu_torch.parallel import gather_state, state_digest
    from intro_tc_vae_tpu_torch.parallel.mesh import sharded_keys
    from intro_tc_vae_tpu_torch.train import images_per_second

    def counts():
        return {**all_launches(), **{f"calls.{k}": v for k, v in tc_cuda.CALLS.items()}}

    torch.cuda.reset_peak_memory_stats()
    box = []
    reset_all_launches()
    with synthetic_steps(TP_STEPS), launches_per_phase(counts) as (phase_e, phase_d):
        by_name = profiled_steps(
            lambda: box.append(cli_main.cli(["-f", FLAGSHIP, "-u", json.dumps(update)])),
            wait=TP_STEPS - PROFILED_STEPS - 1)
    state = box[0]
    local, whole = state_bytes(state)
    return dict(history=state.history, counts=counts(), phase_e=phase_e, phase_d=phase_d,
                device_ms=sum(by_name.values()) / PROFILED_STEPS / 1e3,
                wall_ms=MAIN_B / images_per_second(state, MAIN_B) * 1e3,
                peak=torch.cuda.max_memory_allocated(), local_bytes=local, whole_bytes=whole,
                sharded=len(sharded_keys(state.model)),
                replicated=state_digest(state.model, replicated_only=True),
                whole={k: v.detach().cpu() for k, v in gather_state(state.model).items()},
                samples=state.samples.cpu(), device=str(next(state.model.parameters()).device))


def tp_rank(grid: str, out_path: str) -> None:
    """One rank of phase 14 (``--tp-rank``), started by start_ranks:
    ``tp_train`` on grid ``grid`` of TP_GRIDS (data_parallel the total,
    model_parallel TP_MODEL), its final checkpoint beside the results; on
    grid (b) then one fp32 gate step on its rows and slices (``dp_step``).
    Writes its results to ``out_path``."""
    import torch
    import torch.distributed as dist

    from intro_tc_vae_tpu_torch.parallel import make_mesh

    update = {**TP_UPDATE, "data_parallel": TP_GRIDS[grid], "model_parallel": TP_MODEL,
              "checkpoint_dir": os.path.join(os.path.dirname(out_path), "saves")}
    out = {"train": tp_train(update), "backend": dist.get_backend()}
    torch.cuda.empty_cache()
    if grid == "b":
        mesh = make_mesh(model_parallel=TP_MODEL)
        out["gate"] = dp_step(mesh.device, mesh, FLAGSHIP, update)
        out["gate64"] = dp_step(mesh.device, mesh, FLAGSHIP, update, f64=True)
        data_only = make_mesh()
        out["gate_dp"] = dp_step(data_only.device, data_only, FLAGSHIP,
                                 {**update, "model_parallel": 1})
    torch.save(out, out_path)


def phase_tensor_parallel(card: str) -> dict:
    """Phase 14: tensor parallelism (``model_parallel`` 2) at the flagship's
    full width: configs/intro_tc_ukiyo64.json (conv 64-128-256-512, z 128,
    batch 64, bf16, paired) on synthetic cut to 640 images, tc and conv
    'pallas', TP_STEPS steps through the CLI's entry on ranks of this
    script sharing the one card over gloo (``start_ranks``).

    (a) TP2 x DP1 (2 ranks) and (b) TP2 x DP2 (4 ranks, data_parallel 4):
    every loss finite and equal on all ranks; per rank the launches of
    each phase equal ``expected_intro_launches("pallas", "pallas")`` (the
    routed 64 -> 64 convs are never cut at min_dim 256: each rank runs
    them whole; on (b), whose data axis takes BatchNorm's plain version,
    no BatchNorm kernel), the TC's 5 calls a step take the single-device
    route on (a) and the gathered one on (b); replicated leaves bit-equal and the
    gathered state equal on all ranks; each rank's bytes of parameters,
    statistics and optimizer state against the whole state's; peak device
    memory per rank. (c) One step of (b)'s four ranks against the same
    step in this process on the whole batch (``gate_step``): fp32 with the
    kernels, TF32 off, at phase 7 (b)'s gate on the parameters (and the
    same step on the four ranks as data-parallel ones, no model axis,
    for comparison: in fp32 the encoder's updated weights, within 2 lr,
    move phase D's statistics by ~1e-3 with or without the model axis),
    and float64 (tc and conv 'xla'), which also holds the BatchNorm
    running statistics (rtol/atol 1e-6). (d) (b)'s one final checkpoint (rank 0
    wrote it) holds the gathered state bit for bit, and loaded in this
    process it decodes a fixed noise batch bit-equal to a model holding
    the gathered parameters. (e) Device ms/step and wall ms/step per
    rank of (a) and (b) beside one process's (the same run in this
    process): ranks that share one card and a host's gloo are a cost,
    not a scaling figure."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    one_dir = tempfile.mkdtemp(prefix="chip_smoke_tp1_")
    one = tp_train({**TP_UPDATE, "checkpoint_dir": one_dir})
    shutil.rmtree(one_dir)
    seconds = {"one process": time.perf_counter() - t0}
    tail = final_decode_launches("pallas")
    results = {}
    for grid, n in TP_GRIDS.items():
        # a data axis of more than one rank: its BatchNorm takes the plain version
        want_e, want_d = expected_intro_launches(
            "pallas", "pallas", bn=(0, 0) if n // TP_MODEL > 1 else None)
        t0 = time.perf_counter()
        work = tempfile.mkdtemp(prefix=f"chip_smoke_tp_{grid}_")
        ranks, rank0_log = start_ranks(f"phase 14 ({grid})", n, ["--tp-rank", grid], work)
        seconds[f"({grid}) ranks"] = time.perf_counter() - t0
        saves = [os.path.join(work, "saves", f)
                 for f in sorted(os.listdir(os.path.join(work, "saves")))]
        results[grid] = ranks
        route = "tc_logsumexp_gathered" if grid == "b" else "tc_logsumexp"
        other = "tc_logsumexp" if grid == "b" else "tc_logsumexp_gathered"
        calls_e = {f"calls.{route}": 3, f"calls.{other}": 0}
        calls_d = {f"calls.{route}": 2, f"calls.{other}": 0}
        for r, out in enumerate(ranks):
            a = out["train"]
            if len(a["history"]) != TP_STEPS:
                die(f"phase 14 ({grid}): rank {r}: {len(a['history'])} steps, "
                    f"expected {TP_STEPS}")
            for rec in a["history"]:
                for k, v in rec.items():
                    if isinstance(v, float) and not math.isfinite(v):
                        die(f"phase 14 ({grid}): rank {r}: non-finite {k} at step {rec['step']}")
            e = {k: TP_STEPS * v for k, v in {**want_e, **calls_e}.items()}
            d = {k: TP_STEPS * v for k, v in {**want_d, **calls_d}.items()}
            total = {k: e[k] + d[k] + tail.get(k, 0) for k in e}
            for label, got, want in (("phase E", a["phase_e"], e), ("phase D", a["phase_d"], d),
                                     ("total", a["counts"], total)):
                if got != want:
                    die(f"phase 14 ({grid}): rank {r}: {label} counts {got}, expected {want}")
            if out["backend"] != "gloo" or a["device"] != DP_DEVICE or not a["sharded"]:
                die(f"phase 14 ({grid}): rank {r}: backend {out['backend']}, device "
                    f"{a['device']}, {a['sharded']} sharded leaves")
            strip = [{k: v for k, v in h.items() if k != "seconds"} for h in a["history"]]
            if strip != [{k: v for k, v in h.items() if k != "seconds"}
                         for h in ranks[0]["train"]["history"]]:
                die(f"phase 14 ({grid}): rank {r}'s metrics differ from rank 0's")
            if a["replicated"] != ranks[0]["train"]["replicated"]:
                die(f"phase 14 ({grid}): rank {r}'s replicated leaves differ from rank 0's")
            if not same(a["whole"], ranks[0]["train"]["whole"]) or \
                    not same(a["samples"], ranks[0]["train"]["samples"]):
                die(f"phase 14 ({grid}): rank {r}'s gathered state or samples differ")
        a0 = ranks[0]["train"]
        last = a0["history"][-1]
        print(f"phase 14 ({grid}): {n} ranks (gloo, one card; {n // TP_MODEL} data x "
              f"{TP_MODEL} model), {TP_STEPS} steps of global batch {MAIN_B}, finite losses "
              f"(last lossE {last['lossE']:.6g} lossD {last['lossD']:.6g}) equal on all ranks; "
              f"per rank phase E {a0['phase_e']}, phase D {a0['phase_d']} (exact); "
              f"{a0['sharded']} leaves cut; replicated leaves bit-equal")
        for line in rank0_log.splitlines():
            if line.startswith(("distributed:", "training throughput")):
                print(f"phase 14 ({grid}): rank 0 says: {line}")
        if grid == "b":
            torch.cuda.empty_cache()
            update = {**TP_UPDATE, "data_parallel": n, "model_parallel": TP_MODEL}
            dev = torch.device(DP_DEVICE)
            one_step = dp_step(dev, None, FLAGSHIP, update)
            gate_step("phase 14 (c)", f"{n} ranks (TP2 x DP2)", [out["gate"] for out in ranks],
                      one_step, stats="print")
            gate_step("phase 14 (c)", f"{n} data-parallel ranks, no model axis",
                      [out["gate_dp"] for out in ranks], one_step, stats="print")
            gate_step("phase 14 (c)", f"{n} ranks (TP2 x DP2)",
                      [out["gate64"] for out in ranks],
                      dp_step(dev, None, FLAGSHIP, update, f64=True), rtol=1e-6,
                      stats=dict(rtol=1e-6, atol=1e-6))
            tp_checkpoint(saves, ranks[0]["train"]["whole"])
        shutil.rmtree(work)
        seconds[f"({grid}) all"] = time.perf_counter() - t0

    # (e) and the state's bytes
    print("phase 14: seconds " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print(f"phase 14 (e): one process: device {one['device_ms']:.3f} ms/step, wall "
          f"{one['wall_ms']:.1f} ms/step, peak {one['peak'] / 2**20:.0f} MiB, state "
          f"{one['whole_bytes']} B on {card}")
    for grid, ranks in results.items():
        for r, out in enumerate(ranks):
            a = out["train"]
            print(f"phase 14 (e): ({grid}) rank {r}: device {a['device_ms']:.3f} ms/step, wall "
                  f"{a['wall_ms']:.1f} ms/step, peak {a['peak'] / 2**20:.0f} MiB; state "
                  f"{a['local_bytes']} of {a['whole_bytes']} B = "
                  f"{a['local_bytes'] / a['whole_bytes']:.4f} of the whole (predicted 0.52) "
                  f"on {card}; ranks share one card over gloo: a cost, not a scaling figure")
        if ranks[0]["train"]["whole_bytes"] != one["whole_bytes"]:
            die(f"phase 14 ({grid}): the whole state counts {ranks[0]['train']['whole_bytes']} "
                f"B, one process {one['whole_bytes']} B")
    return {"one": {k: one[k] for k in ("device_ms", "wall_ms", "peak", "whole_bytes")},
            "ranks": {g: [{k: out["train"][k] for k in ("device_ms", "wall_ms", "peak",
                                                         "local_bytes")} for out in ranks]
                      for g, ranks in results.items()}}


def tp_checkpoint(paths: list, whole: dict) -> None:
    """Phase 14 (d): the ranks' one final checkpoint holds ``whole`` (the
    gathered state) bit for bit; loaded in this process, its eval decode of
    a fixed noise batch equals, bit for bit, that of a model given the
    gathered parameters."""
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.data import load_dataset
    from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE
    from intro_tc_vae_tpu_torch.solvers.base import decode
    from intro_tc_vae_tpu_torch.utils import load_model

    cfg = load_config(FLAGSHIP, TP_UPDATE)
    if len(paths) != 1 or not paths[0].endswith(f"model_epoch_0_iter_{TP_STEPS}"):
        die(f"phase 14 (d): the ranks left {paths}, expected one final checkpoint")
    payload = torch.load(paths[0], map_location="cpu", weights_only=True)
    saved = {**{f"encoder.{k}": v for k, v in payload["encoder"].items()},
             **{f"decoder.{k}": v for k, v in payload["decoder"].items()}}
    if not same(saved, whole):
        die("phase 14 (d): the checkpoint differs from the ranks' gathered state")
    _, size, channels, cdim = load_dataset(cfg.dataset)
    kw = dict(arch=cfg.arch, cdim=cdim, zdim=cfg.z_dim, channels=tuple(channels),
              image_size=size, compute_dtype=torch.bfloat16, conv_impl="pallas")
    dev = torch.device(DP_DEVICE)
    loaded = load_model(SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev), paths[0])
    given = SoftIntroVAE(Encoder(**kw), Decoder(**kw)).to(dev)
    given.load_state_dict(whole)
    noise = torch.randn((MAIN_B, cfg.z_dim), generator=torch.Generator().manual_seed(7)).to(dev)
    a, b = decode(loaded.decoder, noise, train=False), decode(given.decoder, noise, train=False)
    if not torch.equal(a, b):
        die("phase 14 (d): the checkpoint's decode differs from the gathered parameters'")
    print(f"phase 14 (d): one checkpoint {os.path.basename(paths[0])} (rank 0 wrote it) holds "
          f"the gathered state bit for bit ({len(saved)} tensors); loaded in one process its "
          f"decode of {MAIN_B} noise vectors is bit-equal to the gathered parameters'")


# ---------------------------------------------------------------------------
# phase 15: the graphed step
# ---------------------------------------------------------------------------

GRAPH_STEPS = 20  # phase 15 (a): an epoch of synthetic; the ring drains and reuses buffers
GRAPH_UPDATE = {"dataset": "synthetic", "tc_impl": "pallas", "conv_impl": "pallas",
                "use_tensorboard": False}


def host_parts(state) -> dict:
    """The train state's tensors on the host, for comparisons after the
    run's state is gone."""
    import torch

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    return host(train_state_parts(state))


def graph_arm(graph: bool, update: dict | None = None, steps: int = GRAPH_STEPS,
              resume_at: int | None = None, work: str | None = None) -> dict:
    """``steps`` flagship steps through the trainer's ``setup`` with the
    step graphed or eager, the metric ring drained as the train loop
    drains it, every count set to 0 just before and read per phase; with
    ``resume_at``, the state is saved there (in ``work``), the parameters
    perturbed and the checkpoint loaded back into the same run, whose
    graph then captures again. Returns the state on the host (also after
    8 steps), every step's metrics as returned and as drained, the counts
    and the captures."""
    import torch

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.solvers.base import RING_DEPTH
    from intro_tc_vae_tpu_torch.train import setup
    from intro_tc_vae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    run = setup(load_config(FLAGSHIP, {**GRAPH_UPDATE, **(update or {})}), graph=graph)
    run.state.model.train()
    solver, state = run.solver, run.state
    k = solver.scan_steps
    calls = []
    while len(calls) < steps // k:
        with contextlib.closing(iter(run.loader)) as epoch:
            calls.extend(epoch)
    calls = calls[:steps // k]
    returned, drained, at8 = [], [], None
    reset_all_launches()
    with launches_per_phase() as (phase_e, phase_d):
        for i, batch in enumerate(calls):
            if resume_at is not None and i == resume_at:
                path = save_checkpoint(state, 0, state.step, "graph_", work)
                with torch.no_grad():
                    for p in state.model.parameters():
                        p.add_(1.0)
                load_checkpoint(path, state)
            _, m = solver.train_step(state, batch)
            returned.append(m)
            if len(solver.metric_ring) >= RING_DEPTH + 2:
                drained.extend(solver.drain_metrics(keep_tail=2))
            if state.step == 8:
                at8 = host_parts(state)
        torch.cuda.synchronize()
    drained.extend(solver.flush_writes())
    per_step = []
    for m in returned:  # a call of K steps returns [K] metrics
        rows = {name: v.reshape(-1).tolist() for name, v in m.items()}
        per_step.extend({name: rows[name][j] for name in rows} for j in range(k))
    pool = sum(len(v) for v in solver.metric_ring._free.values())
    return {"state": host_parts(state), "at8": at8, "metrics": per_step,
            "drained": [m for m, _ in drained], "steps": [s for _, s in drained],
            "counts": all_launches(), "phase_e": dict(phase_e), "phase_d": dict(phase_d),
            "captures": solver.graphed.captures if solver.graphed is not None else 0,
            "pool": pool}


def train_arm(update: dict, graph: bool, steps: int = 20):
    """``steps`` flagship steps through ``train_soft_intro_vae`` (the
    CLI's entry, whose ``graph`` the CLI leaves to the rule), checkpoints
    in a temporary directory; the final TrainState."""
    import shutil
    import tempfile

    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.train import train_soft_intro_vae

    work = tempfile.mkdtemp(prefix="chip_smoke_saves_")
    try:
        state = train_soft_intro_vae(load_config(FLAGSHIP, {**update, "checkpoint_dir": work}),
                                     graph=graph)
    finally:
        shutil.rmtree(work)
    if len(state.history) != steps:
        die(f"phase 15: {len(state.history)} steps, expected {steps}")
    return state


def phase_graphed_step(card: str) -> dict:
    """Phase 15: the flagship's step as one captured CUDA graph against
    the eager step (``solvers/graph.py``), cuDNN deterministic.
    (a) GRAPH_STEPS steps of each arm from one seed through ``setup``:
    parameters, BatchNorm statistics, optimizer states and every metric
    bit-equal. (b) The launches of each phase of both arms exactly
    ``expected_intro_launches`` (a replay adds the graph's tally). (c)
    Host img/s (``images_per_second``) and device ms/step
    (``profiled_steps``) of both arms through ``train_soft_intro_vae``,
    in turns, twice. (d) ``analysis/profile_step.py`` on both arms: launches
    per step, host ms/step, idle share; the metric ring's pinned buffers
    (one a slot, reused) leave every drained metric equal to the step's
    own. (e) scan_steps 4, graphed: two calls (8 steps) bit-equal to (a)'s
    graphed run after 8 steps; one resume in the middle of a graphed run
    (save, perturb, load into the same run: its graph captures again)
    bit-equal to (a)'s uninterrupted graphed run."""
    import shutil
    import tempfile

    from intro_tc_vae_tpu_torch.analysis import profile_step as ps
    from intro_tc_vae_tpu_torch.train import images_per_second

    out = {}
    want_e, want_d = expected_intro_launches("pallas", "pallas")
    with cudnn_deterministic():
        arms = {graph: graph_arm(graph) for graph in (False, True)}
    eager, graphed = arms[False], arms[True]
    # (a)
    if graphed["captures"] != 1 or eager["captures"] != 0:
        die(f"phase 15 (a): captures eager {eager['captures']}, graphed {graphed['captures']}")
    for part in ("model", "opt_e", "opt_d", "step"):
        if not same(eager["state"][part], graphed["state"][part]):
            die(f"phase 15 (a): the graphed run's {part} differs from the eager run's")
    if eager["metrics"] != graphed["metrics"]:
        die("phase 15 (a): the graphed run's metrics differ from the eager run's")
    print(f"phase 15 (a): {GRAPH_STEPS} flagship steps (bf16, batch 64, tc and conv pallas, "
          f"cuDNN deterministic), graphed (1 capture after 3 eager steps) against eager: "
          f"parameters, BatchNorm statistics, Adam states and all "
          f"{len(eager['metrics'][0])} metrics of every step bit-equal")
    # (b)
    for label, arm in (("eager", eager), ("graphed", graphed)):
        for what, got, want in (
                ("phase E", arm["phase_e"], {k: GRAPH_STEPS * v for k, v in want_e.items()}),
                ("phase D", arm["phase_d"], {k: GRAPH_STEPS * v for k, v in want_d.items()}),
                ("total", arm["counts"],
                 {k: GRAPH_STEPS * (want_e[k] + want_d[k]) for k in want_e})):
            if got != want:
                die(f"phase 15 (b): {label}: {what} launches {got}, expected {want}")
    print(f"phase 15 (b): launches of both arms exactly as derived, {GRAPH_STEPS} steps: "
          f"phase E {graphed['phase_e']}, phase D {graphed['phase_d']}")
    # (d), the ring
    for label, arm in (("eager", eager), ("graphed", graphed)):
        if arm["drained"] != arm["metrics"] or arm["steps"] != list(range(1, GRAPH_STEPS + 1)):
            die(f"phase 15 (d): {label}: the ring's drained metrics differ from the steps'")
        if not 0 < arm["pool"] <= 10:  # RING_DEPTH + 2 slots
            die(f"phase 15 (d): {label}: {arm['pool']} pinned buffers in the ring's pool")
    print(f"phase 15 (d): the metric ring: {graphed['pool']} pinned buffers for "
          f"{GRAPH_STEPS} steps in each arm, reused; every drained metric equal to the "
          "step's own")
    # (e)
    work = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    try:
        with cudnn_deterministic():
            scan = graph_arm(True, {"scan_steps": 4}, steps=8)
            resumed = graph_arm(True, resume_at=GRAPH_STEPS // 2, work=work)
    finally:
        shutil.rmtree(work)
    for part in ("model", "opt_e", "opt_d", "step"):
        if not same(scan["state"][part], graphed["at8"][part]):
            die(f"phase 15 (e): scan_steps 4 graphed: {part} differs from 8 graphed steps")
    if scan["metrics"] != graphed["metrics"][:8] or scan["captures"] != 1:
        die(f"phase 15 (e): scan_steps 4 graphed: metrics differ or {scan['captures']} "
            "captures")
    for part in ("model", "opt_e", "opt_d", "step"):
        if not same(resumed["state"][part], graphed["state"][part]):
            die(f"phase 15 (e): the resumed graphed run's {part} differs from the "
                "uninterrupted one's")
    if resumed["metrics"] != graphed["metrics"] or resumed["captures"] != 2:
        die(f"phase 15 (e): resumed: metrics differ or {resumed['captures']} captures, "
            "expected 2")
    print("phase 15 (e): scan_steps 4 graphed (4 replays a call, 1 capture), 8 steps "
          "bit-equal to 8 graphed steps of scan_steps 1; a resume at step 10 into the same "
          "graphed run (captured again) bit-equal to the uninterrupted graphed run")
    del arms, eager, graphed, scan, resumed
    # (c)
    update = {**GRAPH_UPDATE, "num_epochs": 1}
    rates, device = {}, {}
    for _ in range(2):
        for label, graph in (("eager", False), ("graphed", True)):
            rates.setdefault(label, []).append(
                images_per_second(train_arm(update, graph), MAIN_B))
            by_name = profiled_steps(lambda: train_arm(update, graph))
            device.setdefault(label, []).append(sum(by_name.values()) / PROFILED_STEPS / 1e3)
    out["img_s"], out["device_ms"] = rates, device
    print("phase 15 (c): flagship (tc and conv pallas, bf16, batch 64), in turns, twice: "
          "host img/s (steps 5-20) " + json.dumps({k: [round(v, 1) for v in r]
                                                   for k, r in rates.items()})
          + ", device ms/step " + json.dumps({k: [round(v, 3) for v in r]
                                             for k, r in device.items()}) + f" on {card}")
    # (d), profile_step
    out["profile"] = {}
    for label, graph in (("eager", False), ("graphed", True)):
        r = ps.profile_step(steps=5, wall_iters=20, graph=graph)
        out["profile"][label] = r
        if graph and r["unattributed_per_step"] > 0.05 * r["work_items_per_step"]:
            die(f"phase 15 (d): profile_step left {r['unattributed_per_step']} of "
                f"{r['work_items_per_step']} kernels a step unattributed")
        launches = {k: v for k, v in r["launches_per_step"].items() if v}
        print(f"phase 15 (d): profile_step {label}: launches/step {json.dumps(launches)}, "
              f"host ms/step {r['host_ms_step_untraced']:.3f} (untraced; traced "
              f"{r['host_ms_step']:.3f}), wall ms/step {r['wall_ms_step']:.3f}, device busy "
              f"{r['busy_ms_step']:.3f} ms/step, idle share {r['idle_share']:.4f}; "
              f"categories " + json.dumps({k: round(v, 3) for k, v in r["categories"].items()})
              + f"; host ms/step in ops " + json.dumps(
                  {k: round(v, 3) for k, v in r["host_op_ms_step"].items()})
              + f"; unattributed kernels a step {r['unattributed_per_step']}"
              + f"; wrappers' host ms/step "
              + json.dumps({k: round(v, 4) for k, v in r["wrapper_host_ms_step"].items()})
              + f" on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the harnesses
# ---------------------------------------------------------------------------

HARNESS_STEPS = 10        # (d): the flagship with the writer on, synthetic cut to 10 steps
MODEL_VIS_SAMPLES = 256   # (e): images encoded on the card and on the CPU
# (e): fp32 with TF32 off on both sides: cuDNN's and the CPU's convolutions
# sum in other orders, a few float32 ulps of a reduction over up to 4,608
# products (3 x 3 x 512) a layer through 4 stages; the bound is on the
# largest difference over the largest magnitude
MODEL_VIS_RTOL = 1e-4


def relative_err(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def harness_model_vis(card: str, work: str) -> None:
    """(e) ``model_vis``: its entry point on the card (fresh flagship-width
    weights, ``synthetic``), then the encodes of MODEL_VIS_SAMPLES images
    and the traversal decodes of the first image's code on the card
    against the same weights on the CPU."""
    import copy

    import torch

    from intro_tc_vae_tpu_torch.analysis import model_vis
    from intro_tc_vae_tpu_torch.train import true_fp32

    r = model_vis.main(["--dataset", "synthetic", "--arch", "conv", "--z-dim", "128",
                        "--out", os.path.join(work, "modelvis")])
    torch.manual_seed(0)
    solver, state, ds = model_vis.build_model("conv", 128, "synthetic", device="cuda")
    if r["encoded"] != min(2000, len(ds)):
        die(f"phase 16 (e): model_vis encoded {r['encoded']} of {len(ds)} images")
    cpu_solver, cpu_state, _ = model_vis.build_model("conv", 128, "synthetic", device="cpu")
    cpu_state.model.load_state_dict(copy.deepcopy(state.model.state_dict()))
    with true_fp32("fp32"):
        z, labels = model_vis.encode_dataset(solver, state, ds, MODEL_VIS_SAMPLES)
        z_cpu, labels_cpu = model_vis.encode_dataset(cpu_solver, cpu_state, ds,
                                                     MODEL_VIS_SAMPLES)
        rows = model_vis.traversals(state, z_cpu[0])
        rows_cpu = model_vis.traversals(cpu_state, z_cpu[0])
    enc_err = relative_err(z, z_cpu)
    dec_err = max(relative_err(a, b) for a, b in zip(rows, rows_cpu))
    if (labels != labels_cpu).any() or enc_err > MODEL_VIS_RTOL or dec_err > MODEL_VIS_RTOL:
        die(f"phase 16 (e): model_vis on the card vs the CPU: encodes {enc_err:.3g}, "
            f"traversal decodes {dec_err:.3g} (bound {MODEL_VIS_RTOL})")
    print(f"phase 16 (e): model_vis: {r['encoded']} images encoded on the card; drawn "
          f"{r['drawn']}, not drawn {r['not_drawn']} (projections: "
          + json.dumps(r["projections"]) + f"); {MODEL_VIS_SAMPLES} encodes and "
          f"{len(rows)} x {len(rows[0])} traversal decodes on the card vs the CPU, fp32: "
          f"largest difference over the largest magnitude {enc_err:.3g} / {dec_err:.3g} "
          f"(bound {MODEL_VIS_RTOL}) on {card}")


def harness_trend(card: str, work: str) -> None:
    """(f) ``eval_config5_trend`` on synthetic128, --steps 4 --eval-points
    2: points at steps 0, 2 and 4, every value finite, no .partial.json
    left; the TC and conv kernels ran."""
    import math

    from intro_tc_vae_tpu_torch.analysis import eval_config5_trend

    out = os.path.join(work, "trend")
    reset_all_launches()
    r = eval_config5_trend.main(["--steps", "4", "--eval-points", "2", "--out", out])
    launched = all_launches()
    points = r["points"]
    values = {k: v for p in points for k, v in p.items() if isinstance(v, float)}
    if [p["step"] for p in points] != [0, 2, 4] or not all(map(math.isfinite, values.values())):
        die(f"phase 16 (f): eval_config5_trend points {points}")
    if os.path.exists(out + ".partial.json") or not os.path.exists(out + ".json"):
        die("phase 16 (f): eval_config5_trend left its .partial.json or wrote no .json")
    if not launched["tc_fwd"] or not launched["conv3x3_fwd_wgmma"]:
        die(f"phase 16 (f): the 128 px steps launched {launched}")
    errors = sorted(k for p in points for k in p if k.endswith("_error"))
    print(f"phase 16 (f): eval_config5_trend, synthetic128, 4 steps: points at 0, 2, 4, finite "
          f"(" + ", ".join(f"step {p['step']}: fid_final_encoder {p['fid_final_encoder']}, "
                           f"mig {p.get('mig_score')}" for p in points)
          + f"); families failed for want of a package: {sorted(set(errors))}; figure "
          + ("drawn" if os.path.exists(out + ".png") else f"{os.path.basename(out)}.png not drawn "
             "(matplotlib does not import)")
          + f"; no .partial.json left; {r['total_seconds']} s on {card}")


def harness_comms(card: str) -> None:
    """(g) ``scaling_comms`` on 2 ranks at the flagship's widths: every
    phase's bytes at the gradient average, the metric average and the TC's
    bank gather equal to their closed forms, on both ranks."""
    from intro_tc_vae_tpu_torch.analysis import scaling_comms

    ranks = scaling_comms.run_ranks(2, tiny=False, device="cuda")
    bad = [f"rank {r}: {m}" for r, res in enumerate(ranks)
           for m in scaling_comms.mismatches(res)]
    if bad:
        die("phase 16 (g): scaling_comms: " + "; ".join(bad))
    scaling_comms.print_table(ranks[0])
    print("phase 16 (g): scaling_comms, 2 ranks sharing the card over gloo, flagship widths: "
          "bytes a step at the closed-form sites equal on both ranks "
          + json.dumps({p: r["expected"] for p, r in ranks[0].items() if p != "meta"})
          + f" on {card}")


def phase_harnesses(card: str) -> dict:
    """Phase 16: every ported harness of ``intro_tc_vae_tpu_torch.analysis``
    through its entry point on the card, the outputs in a temporary
    directory. (a) ``bench_conv_kernel`` at batch 64, 64 x 64: its
    on-card equality check and its launch check passed, the hand kernels
    launched in the pallas and hybrid arms and none in cuDNN's. (b)
    ``ceiling``: the flagship's count of one step equal to the closed form
    of its products (``ceiling.products_from_shapes``) plus 5 TC calls'
    operations,
    the sustained bf16 rate, and ``--measure`` for the flagship (the TC and
    conv kernels launched). (c) ``doctor_rehearsal``: exit codes 0, 0, 0,
    1, 1, 1. (d) ``stability_report`` and ``run_vis`` on the flagship's
    TensorBoard run written here (HARNESS_STEPS steps, writer on): every
    curve finite at every step. (e) ``model_vis`` (``harness_model_vis``).
    (f) ``eval_config5_trend`` (``harness_trend``). (g) ``scaling_comms``
    (``harness_comms``). Where matplotlib or sklearn does not import, the
    harnesses name the figures and projections they did not draw."""
    import shutil
    import tempfile

    import torch

    from intro_tc_vae_tpu_torch.analysis import (
        bench_conv_kernel,
        ceiling,
        doctor_rehearsal,
        run_vis,
        stability_report,
    )
    from intro_tc_vae_tpu_torch.config import load_config
    from intro_tc_vae_tpu_torch.train import train_soft_intro_vae

    dev = torch.device("cuda", 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_phase16_")
    seconds, t0 = {}, time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    out = {}
    try:
        # (a)
        r = bench_conv_kernel.main(["--batch", "64", "--size", "64"])
        ran = {name: arm["launches"] for name, arm in r["arms"].items()}
        if (not r["equal"] or not r["launches_ok"] or ran["fwd xla"] or ran["fwd+bwd xla"]
                or not all(ran[n] for n in ("fwd pallas", "fwd+bwd pallas", "fwd+bwd hybrid"))):
            die(f"phase 16 (a): bench_conv_kernel: equal {r['equal']}, launches {ran}")
        out["bench_conv_kernel"] = {k: round(a["us"], 1) for k, a in r["arms"].items()}
        print(f"phase 16 (a): bench_conv_kernel [64, 64, 64, 64] bf16: equal to cuDNN (rel "
              + json.dumps({k: round(e["rel"], 5) for k, e in r["check"].items()})
              + f" < {bench_conv_kernel.REL_TOL}); one call's launches " + json.dumps(ran)
              + "; us " + json.dumps(out["bench_conv_kernel"]) + "; TFLOP/s "
              + json.dumps({k: round(a["tflops"], 1) for k, a in r["arms"].items()})
              + f" on {card}")
        lap("(a)")
        # (b)
        reset_all_launches()
        c = ceiling.main(["--measure", "--only", f"intro_tc:64:{MAIN_B}"])
        launched = all_launches()
        row, = c["rows"]
        solver, state, x = ceiling.build("intro_tc", 64, MAIN_B, dev)
        want = ceiling.products_from_shapes(solver, state, x)
        tc_want = 5 * ceiling.tc_call_ops(MAIN_B, Z_DIM, True)
        del solver, state, x
        count = row["step_flops"]
        if count["products"] != want or count["tc"] != tc_want:
            die(f"phase 16 (b): ceiling counted {count}, closed form products {want}, "
                f"TC {tc_want}")
        if not launched["tc_fwd"] or not launched["conv3x3_fwd_wgmma"]:
            die(f"phase 16 (b): ceiling --measure launched {launched}")
        out["ceiling"] = c
        print(f"phase 16 (b): ceiling, flagship: {count['total']:,} operations a step "
              f"(products {count['products']:,} = the closed form; TC {count['tc']:,}), "
              f"{row['gflop_per_image']} GFLOP/image; sustained bf16 "
              f"{c['sustained_tflops']:.1f} TFLOP/s (nominal {ceiling.NOMINAL_TFLOPS}); ceiling "
              f"{row['ceiling_img_s']} img/s; measured {row['measured_img_s']} img/s graphed, "
              f"{row['pct_of_ceiling']} % of the ceiling on {card}")
        lap("(b)")
        # (c)
        r = doctor_rehearsal.main(["--out", os.path.join(work, "doctor_rehearsal.txt")])
        exits = [case["exit"] for case in r["cases"]]
        if exits != [0, 0, 0, 1, 1, 1]:
            die(f"phase 16 (c): doctor_rehearsal exit codes {exits}, expected 0 0 0 1 1 1")
        print(f"phase 16 (c): doctor_rehearsal: exit codes {exits}; "
              + "; ".join(f"{case['title']}: " + ", ".join(
                  f"{st} {check}" for st, check in case["lines"] if st in ("FAIL", "WARN"))
                  for case in r["cases"]))
        lap("(c)")
        # (d)
        log = os.path.join(work, "runs")  # the writer's run: log_dir + the run's comment
        with synthetic_steps(HARNESS_STEPS):
            train_soft_intro_vae(load_config(FLAGSHIP, {
                "dataset": "synthetic", "tc_impl": "pallas", "conv_impl": "pallas",
                "num_epochs": 1, "use_tensorboard": True, "log_dir": os.path.join(log, "tb"),
                "test_iter": 10**6, "checkpoint_dir": os.path.join(work, "ck")}))
        run, = os.listdir(log)
        s = stability_report.main(["--run-dir", log, "--run-pattern", "intro_tc",
                                   "--out", os.path.join(work, "stability")])
        v = run_vis.main(["--run-dir", log, "--out", os.path.join(work, "runvis")])
        curves = v["runs"][run]
        if (not all(c["finite"] and c["steps"] == HARNESS_STEPS for c in s["curves"].values())
                or any(curves[k]["steps"] != HARNESS_STEPS for k in
                       ("r_loss_scaled", "kl_loss_scaled", "loss_e", "loss_d", "diff_kl"))
                or not v["reconstructions"]):
            die(f"phase 16 (d): stability_report {s['curves']}, run_vis {v}")
        print(f"phase 16 (d): stability_report: 6 curves x {HARNESS_STEPS} steps, all finite; "
              f"figure " + ("drawn" if s["figure"] else "stability.png not drawn (matplotlib "
                            "does not import)")
              + f"; run_vis: {len(curves)} curves read, figures drawn {len(v['figures'])}, not "
              f"drawn {v['not_drawn']}, {len(v['reconstructions'])} reconstruction written")
        lap("(d)")
        harness_model_vis(card, work)
        lap("(e)")
        harness_trend(card, work)
        lap("(f)")
        harness_comms(card)
        lap("(g)")
    finally:
        shutil.rmtree(work)
    print("phase 16: seconds by part " + json.dumps(seconds))
    return out


# ---------------------------------------------------------------------------
# phase 17: the benchmark program
# ---------------------------------------------------------------------------

BENCH_ARMS = (("xla", "xla"), ("pallas", "pallas"))  # (tc_impl, conv_impl)
INFER_PACKS = (0, 4)
EVAL_REMAINDER = 17  # (d): a remainder batch of the metric families' encodes
# (e): a test_iter of heavy metrics at steps 0 and 4, the graphed step captured between
HEAVY_STEPS, HEAVY_TEST_ITER = 5, 4


def bench_main_arms(card: str) -> dict:
    """(a): ``bench.main`` on the flagship in BENCH_ARMS, graphed and eager,
    its lines printed; every step's losses finite (``main`` checks each
    drained step); the launches of each phase exactly phase 4's arm's,
    scaled to the steps run (warm-up and capture included)."""
    from intro_tc_vae_tpu_torch import bench

    out = {}
    for tc_impl, conv_impl in BENCH_ARMS:
        want_e, want_d = expected_intro_launches(tc_impl, conv_impl)
        for graph in (True, False):
            arm = f"tc {tc_impl}, conv {conv_impl}, {'graphed' if graph else 'eager'}"
            reset_all_launches()
            with launches_per_phase() as (phase_e, phase_d):
                r = bench.main(tc_impl=tc_impl, conv_impl=conv_impl, graph=graph)
            n = r["steps"]
            for label, got, want in (
                    ("phase E", phase_e, {k: n * v for k, v in want_e.items()}),
                    ("phase D", phase_d, {k: n * v for k, v in want_d.items()}),
                    ("total", all_launches(), {k: n * (want_e[k] + want_d[k]) for k in want_e})):
                if got != want:
                    die(f"phase 17 (a): {arm}: {label} launches {got}, expected {want}")
            out[arm] = r
            print(f"phase 17 (a): bench.main {arm}: {r['img_s']:.1f} img/s, "
                  f"{r['device_ms_per_step']:.3f} ms/step on the card's clock, {n} steps with "
                  f"exact launches (phase 4's arm x {n}), last loss_enc "
                  f"{r['last_loss_enc']:.6g} on {card}")
    return out


def bench_infer(card: str) -> dict:
    """(b): ``bench.infer`` at batch 256 with pack 0 and 4, graphed and
    eager, each under ``memory_of`` (a graphed run leaves nothing
    allocated once it is gone). The graphs that ``infer`` timed (the
    ``GraphedEval`` of each surface whose img/s it printed) are held
    bit-equal to their eager passes, on the bench's inputs and on another
    draw, before and after BatchNorm's running statistics move in place."""
    import torch

    from intro_tc_vae_tpu_torch import bench

    mib = 2 ** 20

    def checked(pack: int) -> dict:
        r = bench.infer(pack=pack)
        state, inputs = r["state"], r["inputs"]
        for when in ("", " after a train-mode pass"):
            if when:
                state.model.train()
                with torch.no_grad():
                    state.model.decoder(torch.randn_like(inputs["decode"]))
                    state.model.encoder(inputs["encode"])
            for name, run in r["runs"].items():
                inp = inputs[name]
                other = torch.rand_like(inp) if inp.dim() == 4 else torch.randn_like(inp)
                for x in (inp, other):
                    if not torch.equal(run(x).clone(), run.fn(x)):
                        die(f"phase 17 (b): pack {pack}: the timed graph of {name} differs "
                            f"from the eager pass{when}")
                if run.captures != 1:
                    die(f"phase 17 (b): pack {pack}: {name}: {run.captures} captures, "
                        "expected 1")
        return {"rows": r["rows"]}

    out = {}
    for pack in INFER_PACKS:
        graphed = memory_of(lambda: checked(pack))
        eager = memory_of(lambda: {"rows": bench.infer(pack=pack, graph=False)["rows"]})
        if graphed["left_bytes"] != 0:
            die(f"phase 17 (b): a graphed infer run (pack {pack}) left "
                f"{graphed['left_bytes'] / mib:.2f} MiB allocated once it was gone")
        out[pack] = {"graphed": graphed["rows"], "eager": eager["rows"]}
        print(f"phase 17 (b): bench.infer batch {bench.INFER_BATCH}, pack {pack}: img/s graphed "
              + json.dumps(graphed["rows"]) + ", eager " + json.dumps(eager["rows"])
              + "; the timed graphs of decode, encode and decode_u8 bit-equal to eager (two "
              "inputs, before and after BatchNorm's statistics moved); left allocated after "
              "the run: "
              f"graphed {graphed['left_bytes'] / mib:.2f}, eager {eager['left_bytes'] / mib:.2f}"
              f" MiB on {card}")
    return out


class ScalarSink:
    """A writer that keeps the scalars a score family writes."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, global_step=None):
        self.scalars[tag] = value

    def add_scalars(self, main, values, global_step=None):
        self.scalars.update({f"{main}/{k}": v for k, v in values.items()})


def graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in graphs' private pools: its
    segments outside the default pool (id (0, 0)). A capture empties the
    allocator's cache first, so ``memory_reserved`` cannot show them."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def eval_encoder_after_steps(card: str) -> dict:
    """(d): the flagship through the trainer's setup (graphed step): the
    solver's eval encoder captured at batch 64 and at a remainder batch,
    then GRAPH_STEPS graphed train steps, then its replays bit-equal to
    the eager encoder (BatchNorm's statistics moved in place under the
    graphs); the eval graphs' memory beside the graphed train step's, their
    one shared pool against a pool for each graph (which must not be
    smaller); one test_iter's MIG and modularity, eager and graphed, in
    seconds."""
    import gc

    import numpy as np
    import torch

    from intro_tc_vae_tpu_torch.evaluation import metrics as em
    from intro_tc_vae_tpu_torch.solvers.graph import CudaGraph, GraphedEval

    class OwnPool(CudaGraph):
        """A graph in a pool of its own, whatever pool it is offered."""

        def __init__(self, pool=None):
            super().__init__()

    mib = 2 ** 20
    run, batches = trainer_setup(GRAPH_UPDATE, GRAPH_STEPS)
    solver, state = run.solver, run.state
    ds = solver.dataset
    images = ds.get_batch(np.arange(3 * MAIN_B + EVAL_REMAINDER) * 7 % len(ds))
    full, rem = images[:MAIN_B], images[MAIN_B:MAIN_B + EVAL_REMAINDER]
    graphed, eager = solver.make_eval_encoder(state), solver.make_eval_encoder(state, eager=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()  # no segment of an earlier graph's pool is left
    base_pools = graph_pool_bytes()
    pools = -base_pools
    for _ in range(2):  # eager warm-up, then the capture, of each shape
        graphed(full)
        graphed(rem)
    torch.cuda.synchronize()
    capture_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    pools += graph_pool_bytes()
    for batch in batches:
        solver.train_step(state, batch)
    torch.cuda.synchronize()
    solver.flush_writes()
    if solver.graphed is None or solver.graphed.captures != 1:
        die("phase 17 (d): the train step was not graphed")
    step_pool = graph_pool_bytes() - pools - base_pools
    peaks = {}
    for label, fn in (("eager", eager), ("graphed", graphed)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn(full)
        fn(rem)
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() - before
    for what, batch in (("batch 64", images[2 * MAIN_B:3 * MAIN_B]), ("a remainder", rem)):
        for got, want in zip(graphed(batch), eager(batch)):
            if not np.array_equal(got, want):
                die(f"phase 17 (d): the graphed eval encoder differs from the eager one at "
                    f"{what} after {GRAPH_STEPS} graphed steps")
    if solver._eval_encode.captures != 2:
        die(f"phase 17 (d): {solver._eval_encode.captures} eval captures, expected 2")
    # the same two captures, each graph in a pool of its own
    separate = GraphedEval(solver._eval_encode.fn, (state.model.encoder,), graph_factory=OwnPool)
    gc.collect()
    torch.cuda.empty_cache()
    before = graph_pool_bytes()
    for batch in (full, rem):
        x = torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2))).cuda()
        separate(x)
        separate(x)
    torch.cuda.synchronize()
    separate_pools = graph_pool_bytes() - before
    if separate.captures != 2:
        die(f"phase 17 (d): {separate.captures} captures with a pool each, expected 2")
    del separate, x
    if pools > separate_pools:
        die(f"phase 17 (d): the eval graphs' shared pool holds {pools / mib:.2f} MiB, over "
            f"the {separate_pools / mib:.2f} MiB of a pool for each graph")
    seconds = {}
    kwargs = dict(latent_generator=solver.latent_generator, num_samples=len(ds) // 2,
                  batch_size=solver.batch_size)
    for label, fn in (("eager", eager), ("graphed", graphed)):
        for write in (em.write_mig_score, em.write_mod_expl_score):
            sink = ScalarSink()
            t0 = time.perf_counter()
            try:
                write(sink, 0, encode_fn=fn, **kwargs)
            except ImportError as e:  # explicitness needs sklearn, which the card host lacks
                print(f"phase 17 (d): {write.__name__} ({label}): {e!r} after "
                      + json.dumps(sink.scalars))
            seconds[f"{write.__name__} {label}"] = time.perf_counter() - t0
            if not sink.scalars or not all(math.isfinite(v) for v in sink.scalars.values()):
                die(f"phase 17 (d): {write.__name__} ({label}) wrote {sink.scalars}")
    print(f"phase 17 (d): the eval encoder captured at batch 64 and {EVAL_REMAINDER}, then "
          f"{GRAPH_STEPS} graphed flagship steps: its replays bit-equal to the eager encoder; "
          f"eval graphs hold {held / mib:.2f} MiB allocated and {pools / mib:.2f} MiB in "
          f"their shared private pool ({separate_pools / mib:.2f} MiB with a pool for each "
          f"graph; capture peak {capture_peak / mib:.2f}; the graphed step's pool "
          f"{step_pool / mib:.2f}); "
          f"peak over the trained state of two encodes eager {peaks['eager'] / mib:.2f}, "
          f"graphed {peaks['graphed'] / mib:.2f} MiB; one test_iter's seconds "
          + json.dumps({k: round(v, 3) for k, v in seconds.items()}) + f" on {card}")
    return {"seconds": seconds, "held_mib": held / mib, "capture_peak_mib": capture_peak / mib,
            "pools_mib": pools / mib, "separate_pools_mib": separate_pools / mib,
            "step_pool_mib": step_pool / mib,
            "peaks_mib": {k: v / mib for k, v in peaks.items()}}


def eval_static_bytes(graphed_eval) -> int:
    """What a ``GraphedEval`` holds allocated: its static inputs and
    outputs, each rounded to the allocator's 512 bytes."""
    tensors = [t for _, _, static, out in graphed_eval._graphs.values()
               for t in (static, *(out if isinstance(out, tuple) else (out,)))]
    return sum(-(-t.numel() * t.element_size() // 512) * 512 for t in tensors)


def heavy_metrics_run(graph: bool) -> dict:
    """(e): HEAVY_STEPS flagship steps through the trainer's setup with a
    live writer and test_iter HEAVY_TEST_ITER: the image grid and the
    metric families run at steps 0 and 4, where the step is graphed
    through the eval encoder's graphs (captured at step 0, replayed at
    step 4, the train step captured between). For ``memory_of``: what the
    graphs must hold (``static_bytes``) and the eval graphs' captures."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tb_") as log:
        run, batches = trainer_setup({**GRAPH_UPDATE, "use_tensorboard": True, "log_dir": log,
                                      "test_iter": HEAVY_TEST_ITER}, HEAVY_STEPS, graph=graph)
        solver, state = run.solver, run.state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for batch in batches:
            _, metrics = solver.train_step(state, batch)
            solver.check_finite(metrics)
        solver.flush_writes()
        torch.cuda.synchronize()
        run.writer.close()
    step, enc = solver.graphed, solver._eval_encode
    if graph != (step is not None) or graph != (enc is not None):
        die(f"phase 17 (e): graph {graph}, but the step is {'graphed' if step else 'eager'} "
            f"and the eval encoder {'graphed' if enc else 'eager'}")
    if graph and (step.captures != 1 or enc.captures < 1):
        die(f"phase 17 (e): {step.captures} step captures, {enc.captures} eval captures")
    return {"static_bytes": (graph_static_bytes(step) + eval_static_bytes(enc)) if graph else 0,
            "eval_captures": enc.captures if graph else 0}


def phase_bench(card: str) -> dict:
    """Phase 17: ``python -m intro_tc_vae_tpu_torch.bench``'s three modes
    through its functions on the card. (a) ``bench_main_arms``. (b)
    ``bench_infer``. (c) ``headline()``, its fast path once: its JSON line
    printed, every arm's and repeat's img/s finite and positive. (d)
    ``eval_encoder_after_steps``. (e) ``memory_gate`` on
    ``heavy_metrics_run``, eager and graphed."""
    from intro_tc_vae_tpu_torch import bench

    seconds = {}
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    out = {"main": bench_main_arms(card)}
    lap("(a)")
    out["infer"] = bench_infer(card)
    lap("(b)")
    line = bench.headline()
    rates = [v for k, v in line.items() if k.startswith("b") and k[1:2].isdigit()]
    if not all(math.isfinite(v) and v > 0 for v in rates + line["repeats"]):
        die(f"phase 17 (c): headline {line}")
    print(f"phase 17 (c): headline: {len(rates)} configurations, {line['value']:.1f} img/s at "
          f"batch {line['batch']} ({'paired' if line['fuse_passes'] else 'unpaired'}) on "
          f"{line['card']}")
    out["headline"] = line
    lap("(c)")
    out["eval_encoder"] = eval_encoder_after_steps(card)
    lap("(d)")
    eager, graphed = (memory_of(lambda: heavy_metrics_run(g)) for g in (False, True))
    memory_gate("phase 17 (e)", f"{HEAVY_STEPS} steps, heavy metrics at steps 0 and "
                f"{HEAVY_TEST_ITER} ({graphed['eval_captures']} eval captures)", eager, graphed,
                card)
    lap("(e)")
    print("phase 17: seconds by part " + json.dumps(seconds))
    return out


def device_time(card: str) -> None:
    """``--device-time``: device ms per step (``profiled_steps``) of the
    flagship's four arms (bf16) and of configs/vae_synthetic.json (fp32)
    with conv_impl 'pallas' and 'xla', each a 20-step run through the CLI,
    the arms of a config in turns and then in reverse. Prints each run's
    total and the conv kernels' and cuDNN's share of it, and the TF32
    switches the steps ran under (the trainer turns them off for precision
    "fp32")."""
    results = {}
    flagship = [(f"tc {tc_impl}, conv {conv_impl}", FLAGSHIP,
                 {"dataset": "synthetic", "tc_impl": tc_impl, "conv_impl": conv_impl,
                  "num_epochs": 1, "use_tensorboard": False})
                for tc_impl, conv_impl in INTRO_ARMS]
    vae = [(f"vae_synthetic, conv {conv_impl}", VAE_SYNTHETIC,
            {"conv_impl": conv_impl, "num_epochs": 1}) for conv_impl in ("pallas", "xla")]
    for arm, config, update in flagship + flagship[::-1] + vae + vae[::-1]:
        with tf32_at_optimizer_calls() as tf32:
            by_name = profiled_steps(lambda: run_cli(config, update, arm))
        total = sum(by_name.values())
        if total <= 0:
            die(f"--device-time: {arm}: the profiler recorded no device time")

        def share(*words):
            return sum(v for k, v in by_name.items()
                       if any(w in k.lower() for w in words)) / PROFILED_STEPS / 1e3

        rec = {"device_ms_per_step": total / PROFILED_STEPS / 1e3,
               "conv3x3_fwd": share("conv3x3_fwd"), "conv3x3_dw": share("conv3x3_dw"),
               "conv3x3_pack_w": share("conv3x3_pack_w"),
               "cudnn_and_layout": share("cudnn", "nchwtonhwc", "nhwctonchw", "xmma",
                                         "implicit_gemm", "convolve", "wgrad", "dgrad")}
        results.setdefault(arm, []).append(rec)
        print(f"device time: {arm}: " + json.dumps({k: round(v, 3) for k, v in rec.items()})
              + f"; (cudnn.allow_tf32, cuda.matmul.allow_tf32) at its optimizer calls "
              f"{sorted(tf32)} on {card}", flush=True)
    print("device time: ms/step (1st, 2nd run) "
          + json.dumps({arm: [round(r["device_ms_per_step"], 2) for r in runs]
                        for arm, runs in results.items()}) + f" on {card}")


MEMORY_RUNS = (  # label, graph, Adam capturable, steps
    ("eager, capturable Adam", False, True, 5),
    ("eager, capturable=False", False, False, 5),
    ("graphed, warm-up only", True, True, 3),
    ("graphed, capture and 5 replays", True, True, 8),
)


def memory_run(graph: bool, capturable: bool, steps: int) -> dict:
    """One run of MEMORY_RUNS, for ``memory_of``: the flagship (tc and conv
    'pallas', batch 64) through the trainer's setup, ``steps`` steps."""
    import torch

    from intro_tc_vae_tpu_torch.solvers import optim

    run, batches = trainer_setup({"tc_impl": "pallas", "conv_impl": "pallas"}, steps,
                                 graph=graph)
    for opt in (run.state.opt_e, run.state.opt_d):
        optim.place_steps(opt, capturable)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        run.solver.train_step(run.state, batch)
    torch.cuda.synchronize()
    return {"base_bytes": base}


def block_site(e: dict) -> str:
    """A memory-history entry's site: its innermost frame of this
    repository (``intro_tc_vae_tpu_torch`` or this script) beside its
    innermost frame ('?' where it has none: an allocation on autograd's
    thread)."""
    frames = e.get("frames") or []
    own = [f for f in frames if "intro_tc_vae_tpu_torch" in f["filename"]
           or f["filename"].endswith("chip_smoke.py")]

    def where(f):
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"

    return f"{where(own[0]) if own else '?'} | {where(frames[0]) if frames else '?'}"


def replay_trace(trace: list, base: int, windows: list) -> tuple:
    """Replay a memory-history trace (``_snapshot()['device_traces'][0]``)
    from ``base`` bytes allocated when it began: for each (start, end)
    window of entries, {site: bytes live at the window's peak}; and the
    blocks live at the end, {(window, site and stream): bytes} by the
    window that allocated them."""
    live, now = {}, base
    peaks = [(-1, {}) for _ in windows]
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = (i, e)
            now += e["size"]
        elif e["action"] == "free_requested" and e["addr"] in live:
            del live[e["addr"]]
            now -= e["size"]
        else:
            continue
        for w, (start, end) in enumerate(windows):
            if start <= i < end and now > peaks[w][0]:
                peaks[w] = (now, dict(live))
    sites = []
    for _, at_peak in peaks:
        sites.append({})
        for _, e in at_peak.values():
            sites[-1][block_site(e)] = sites[-1].get(block_site(e), 0) + e["size"]
    left: dict = {}
    for i, e in live.values():
        w = next((w for w, (start, end) in enumerate(windows) if start <= i < end), -1)
        key = (w, f"{block_site(e)} | stream {e.get('stream', 0)}")
        left[key] = left.get(key, 0) + e["size"]
    return sites, left


def memory(card: str) -> None:
    """``--memory``: where the flagship's peak device memory goes, eager
    and graphed (MEMORY_RUNS, one after another in this process under the
    allocator's memory history): each run's peak over its set-up, the
    blocks live at each later run's peak by site against the first (eager)
    run's, and what each run leaves allocated once it is gone, by site."""
    import torch

    mib = 2 ** 20
    kept = warm_workspaces()
    print(f"memory: the process's first matrix products, forward and backward, on the current "
          f"and the capture stream kept {kept / mib:,.2f} MiB allocated (cuBLAS and cuBLASLt "
          f"workspaces) on {card}")
    torch.cuda.synchronize()
    base0 = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=4_000_000, stacks="python")
    runs, bounds = [], [0]
    try:
        for label, *args in MEMORY_RUNS:
            runs.append({"label": label, **memory_of(lambda: memory_run(*args))})
            bounds.append(len(torch.cuda.memory._snapshot()["device_traces"][0]))
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sites, left = replay_trace(trace, base0, list(zip(bounds, bounds[1:])))
    for w, r in enumerate(runs):
        print(f"memory: {r['label']}: max_memory_allocated {r['peak_bytes'] / mib:,.1f} MiB, "
              f"{(r['peak_bytes'] - r['base_bytes']) / mib:,.1f} over the set-up; "
              f"{r['large_blocks_peak']} large blocks at the peak; left allocated once the run "
              f"is gone {r['left_bytes'] / mib:,.2f} MiB on {card}")
        for site, b in sorted(((s, b) for (ww, s), b in left.items() if ww == w),
                              key=lambda kv: -kv[1])[:8]:
            print(f"memory:   left allocated {b / mib:9.2f} MiB  {site}")
        if w:
            more = sorted(((k, sites[w].get(k, 0) - sites[0].get(k, 0))
                           for k in set(sites[w]) | set(sites[0])), key=lambda kv: -abs(kv[1]))
            for site, b in more[:8]:
                if abs(b) >= mib:
                    print(f"memory:   at the peak vs eager {b / mib:+9.2f} MiB  {site}")


def main() -> None:
    import torch

    name, card = start()
    from intro_tc_vae_tpu_torch.ops import batchnorm_cuda, conv_cuda, tc_cuda

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
        return out

    with fp32_exact():
        kernels = timed("phase 3 (TC)", phase_kernels, card)
        gathered = timed("phase 3 (TC gathered)", phase_gathered_kernels, card)
        conv = timed("phase 3 (conv)", phase_conv_kernels, card)
        bnk = timed("phase 3 (bn)", phase_bn_kernels, card)
    fwd, g = kernels["fwd"], gathered["times"]
    reached = {"B=64 time / launch floor": fwd[MAIN_B][0] / fwd[MAIN_B][2],
               "B=512 ms": fwd[512][0], "B=2048 bound / time": fwd[2048][1] / fwd[2048][0],
               "gathered ms": g["tc_fwd"], "gathered three kernels ms": g["kernels"]}
    met = {k: v >= TC_FWD_TARGETS[k] if "bound" in k else v <= TC_FWD_TARGETS[k]
           for k, v in reached.items()}
    print("phase 3: tc_fwd targets (printed, not enforced): reached "
          + json.dumps({k: round(v, 5) for k, v in reached.items()}) + ", target "
          + json.dumps(TC_FWD_TARGETS) + ", met " + json.dumps(met) + f" on {card}")

    main_path = timed("phase 4", phase_main_path, card)
    timed("phase 4 (bn)", bn_calls_128, card)
    with fp32_exact():  # same conv algorithms in both runs
        timed("phase 5", phase_in_context, torch.device("cuda", 0))
    other = timed("phase 6", phase_other_paths, card)
    dp = timed("phase 7", phase_data_parallel, card)
    ckpt = timed("phase 8", phase_checkpoints, card)
    data = timed("phase 9", phase_data_paths, card, main_path)
    obs = timed("phase 10", phase_observability, card, main_path)
    timed("phase 11", phase_solver_surface, card)
    at48 = timed("phase 12", phase_48px, card)
    timed("phase 13", phase_options, card)
    timed("phase 14", phase_tensor_parallel, card)
    timed("phase 15", phase_graphed_step, card)
    timed("phase 16", phase_harnesses, card)
    timed("phase 17", phase_bench, card)
    print(f"phase 8: flagship checkpoint {ckpt['bytes']} bytes; save {ckpt['save_s']:.3f} s, "
          f"background save returns in {ckpt['async_return_s']:.3f} s, load "
          f"{ckpt['load_s']:.3f} s; phase 4 img/s with the metric ring "
          + json.dumps({k: round(v, 1) for k, v in main_path["rates"].items()})
          + f" on {card}")


    # What the wgmma wrappers' host time comes to in a flagship step: their
    # calls per step (conv pallas arm) times the host microseconds a call
    # takes, beside the wall time of a step.
    per_step = {k: v / 20 for k, v in main_path["launches"].items()}
    host = conv["host_us"]
    extra_ms = (per_step["conv3x3_fwd_wgmma"] * host["fwd_wgmma"]
                + per_step["conv3x3_dw_wgmma"] * host["dw_wgmma"]) / 1e3
    wall_ms = MAIN_B / main_path["rates"]["tc pallas, conv pallas"] * 1e3
    for label, paths in data["loaders"].items():
        print(f"phase 9 (f): {label}, batch 64, host ms per batch "
              + json.dumps({p: round(r["host_ms_per_batch"], 3) for p, r in paths.items()})
              + ", H2D bytes per step "
              + json.dumps({p: round(r["h2d_bytes_per_step"]) for p, r in paths.items()})
              + f" on {card}")
    print(f"phase 9 (f): Ukiyo-E decode cache {data['decode_s']:.3f} s; flagship img/s on "
          f"ukiyo_e64 (cache) {data['flagship_ukiyo_rate']:.1f}, phase 4 on synthetic "
          f"{main_path['rates']['tc pallas, conv pallas']:.1f}; tc_dsprites img/s "
          + json.dumps({k: round(v, 1) for k, v in data["tc_dsprites_rates"].items()})
          + f" on {card}")
    for cell in ("a", "b"):
        o = obs[cell]
        print(f"phase 10 ({cell}): one test_iter's heavy metrics, s "
              + json.dumps({k: round(v, 3) for k, v in o["heavy_s"].items()})
              + f"; a drain's writes {o['drain_ms']:.3f} host ms ({o['drains']} drains) on "
              f"{card}")
    print(f"phase 10 (c): Inception pool3 {obs['c']['inception_img_s']:.1f} img/s; evaluate "
          f"--fid {obs['c']['eval_s']:.1f} s on {card}")
    print(f"host: the wgmma wrappers (tensor maps, pack and kernel launches) take "
          f"{extra_ms:.3f} ms of host time of a flagship step of {wall_ms:.1f} ms on the host "
          f"clock ({100 * extra_ms / wall_ms:.2f} %)")

    # plain_ms: the plain PyTorch version of the same function; library_ms:
    # one PyTorch call that computes it (cuDNN for the convs), where there
    # is one. The TC backward kernels share the plain backward; the conv
    # forward's and dW's plain version is the library call. launches: the
    # flagship's (tc pallas, conv pallas) run of phase 4; the fp32 conv
    # bodies, which that run does not reach, from phase 6's vae_synthetic;
    # the ragged entry points from phase 12's conv pallas arm.
    tc_plain = {"tc_fwd": "plain_fwd", "tc_bwd_dz": "plain_bwd", "tc_bwd_dmu": "plain_bwd"}
    times = {**{k: {"ms": kernels["times"][k], "plain_ms": kernels["times"][p],
                    "library_ms": None} for k, p in tc_plain.items()}, **conv["times"],
             **bnk["times"]}
    errs = {**kernels["errs"], **conv["errs"], **bnk["errs"]}
    bounds = {**tc_bounds(MAIN_B, MAIN_B), **conv["bounds"], **bnk["bounds"]}
    launches = {**main_path["launches"],
                "conv3x3_fwd": other["conv3x3_fwd"], "conv3x3_dw": other["conv3x3_dw"],
                "conv3x3_fwd_ragged": at48["launches"]["conv3x3_fwd_ragged"],
                "conv3x3_dw_ragged": at48["launches"]["conv3x3_dw_ragged"]}
    entries = [
        {"name": k, "route": "cuda", "source": SOURCE[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"], **bounds[k],
         "library_ms": times[k]["library_ms"]}
        for k in (*tc_cuda.KERNELS, *conv_cuda.KERNELS, *batchnorm_cuda.KERNELS)
    ]
    # the three TC kernels launched in their gathered form, counted by the
    # gathered calls of phase 7's ranks; ms: one gathered call's three
    # kernels against the plain gathered forward and backward (phase 3);
    # bound: the three kernels' bounds at 64 rows against a bank of 128
    g_bounds = tc_bounds(MAIN_B, 2 * MAIN_B).values()
    entries.append({"name": "tc_logsumexp_gathered", "route": "cuda",
                    "source": SOURCE["tc_fwd"],
                    "replaces": "intro_tc_vae_tpu/ops/tc_pallas.py:381",
                    "launches": dp["gathered_calls"], "max_abs_err": gathered["err"],
                    "ms": gathered["times"]["kernels"],
                    "plain_ms": gathered["times"]["plain"],
                    "bound_ms": sum(b["bound_ms"] for b in g_bounds),
                    "bound_by": "bytes" if all(b["bound_by"] == "bytes" for b in g_bounds)
                    else "operations",
                    "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 7, started by the script
        dp_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase 14, started by the script
        tp_rank(sys.argv[2], sys.argv[3])
        sys.exit(0)
    t0 = time.perf_counter()
    if sys.argv[1:2] == ["--device-time"]:  # a profile, not the smoke test
        device_time(start()[1])
        sys.exit(0)
    if sys.argv[1:2] == ["--memory"]:  # an attribution, not the smoke test
        memory(start()[1])
        sys.exit(0)
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
