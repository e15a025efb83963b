"""Fused total-correlation logsumexps: CUDA kernels, autograd, plain version.

Counterpart of ``intro_tc_vae_tpu/ops/tc_pallas.py::tc_logsumexp_pallas``
and ``tc_logsumexp_pallas_gathered``.
``tc_logsumexp_cuda(z, mu, logvar, dataset_size)`` returns
(log prod_l q(z_l), log q(z)), both [B], through three hand-written
kernels in ``csrc/tc_kernels.cu`` (design notes there):

* ``tc_fwd``     replaces ``_tc_fwd_kernel``     (tc_pallas.py:109),
* ``tc_bwd_dz``  replaces ``_tc_bwd_dz_kernel``  (tc_pallas.py:174),
* ``tc_bwd_dmu`` replaces ``_tc_bwd_dmu_kernel`` (tc_pallas.py:202).

The forward leaves three float64 tensors for the backward: ``terms``
[B, Z, 4] (per (j, l): z, 1/v, c, c - lm, so that P = c - 0.5 d^2/v), ``lj``
[B] and ``psum`` [B, GB] = sum_l P[j, i, l], the one thing the backward
needs a sum over l for. The backward recomputes the densities, as the
Pallas VJP does, so no [B, B, z] residual is stored; ``psum`` is O(B^2)
(``scratch_bytes``: 32 KB at B = 64, 2.1 GB at B = 16384), and a shape
whose scratch the device cannot hold is refused, not rerouted.

The two backward kernels cut the reduced axis (i for ``tc_bwd_dz``, j for
``tc_bwd_dmu``) into slices, one warp each, and add the slices' partial
sums in ascending order. ``reduce_slices`` is that cut, a function of the
reduced length alone; ``backward_plan`` adds how many output rows a thread
takes, which changes no sum. ``tc_backward_split_reference`` is
the plain PyTorch version that sums in the same split order. The forward
cuts the bank the same way (``forward_plan``, which its launcher checks);
``tc_forward_split_reference`` is its plain version in its order.

``tc_logsumexp_cuda_gathered(z, mu_bank, logvar, row_off, dataset_size,
global_batch)`` is the data-parallel form: a rank's [B_local, Z] rows of
z and logvar against the all-gathered [GB, Z] mu bank, its rows weighted
as rows row_off.. of the global batch; its backward returns dmu for the
whole bank, which the gather's adjoint sums over the ranks. The same
three kernels run it (they take B_j != B_i, ``row_off`` and
``global_batch``).

``tc_logsumexp_reference`` and ``tc_logsumexp_reference_gathered`` are
the plain PyTorch versions (materialized [B, GB, z], ``torch.logsumexp``,
autograd for the gradient). A wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches the kernels or raises.
``LAUNCHES`` counts kernel launches per kernel and ``CALLS`` the calls
of each wrapper that went to the kernels, so a run can show that its TC
calls went through the kernels, and by which route; both are registered
with ``launch_counts``, which keeps them counting under CUDA graph replay.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.ops import cuda_build, launch_counts
from intro_tc_vae_tpu_torch.ops.density import (
    LOG_2PI,
    LOG_PROB_FLOOR,
    VAR_FLOOR,
    gaussian_log_density_nll,
    log_importance_weight_block,
    minibatch_stratified_sampling,
)

KERNELS = ("tc_fwd", "tc_bwd_dz", "tc_bwd_dmu")
LAUNCHES = launch_counts.register(dict.fromkeys(KERNELS, 0))
CALLS = launch_counts.register(dict.fromkeys(("tc_logsumexp", "tc_logsumexp_gathered"), 0))

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# pointers, then B_j, B_i, Z, dataset_size, row_off, global_batch, the
# plan (the forward's cut: slice_len, n_slices; a backward kernel's: rows,
# slice_len, n_slices)
_SHAPE, _PLAN = [_I, _I, _I, _LL, _I, _I], [_I] * 3
LIBRARY = cuda_build.Library("tc_kernels", {
    "tc_fwd": [_P] * 8 + _SHAPE + [_I] * 2,
    "tc_bwd_dz": [_P] * 9 + _SHAPE + _PLAN,
    "tc_bwd_dmu": [_P] * 7 + _SHAPE + _PLAN,
    "tc_empty": [],
})

MAX_SLICES = 16       # slices of the reduced axis, one warp each: 512 threads
MIN_SLICE_LEN = 8     # rows of the reduced axis a warp takes at least


def reduce_slices(n_red: int) -> tuple[int, int]:
    """(slice_len, n_slices): how the backward kernels cut a reduced axis
    of ``n_red`` rows. Slices of 8 rows up to 128 rows (a short chain per
    warp where the kernels are bound by latency), then 16 slices of a
    multiple of 8 rows. The order of every gradient sum follows from this
    cut and from nothing else."""
    per_slice = -(-n_red // MAX_SLICES)
    slice_len = max(MIN_SLICE_LEN, -(-per_slice // 8) * 8)
    return slice_len, -(-n_red // slice_len)


class BackwardPlan(NamedTuple):
    rows: int        # output rows a thread takes
    slice_len: int
    n_slices: int


def backward_plan(name: str, b_j: int, b_i: int, zdim: int) -> BackwardPlan:
    """The launch of ``tc_bwd_dz`` (b_j output rows, b_i reduced) or
    ``tc_bwd_dmu`` (the reverse). One row a thread fills the card at small
    batches; at larger ones a thread takes 2 rows, and 4 in ``tc_bwd_dmu``,
    whose other operand is 32 bytes a row and column: it is then loaded once
    for those rows. The thresholds are where the H100's times cross
    (PERF.md); ``rows`` changes no sum."""
    n_out, n_red = (b_j, b_i) if name == "tc_bwd_dz" else (b_i, b_j)
    slice_len, n_slices = reduce_slices(n_red)
    warps = n_out * -(-zdim // 32) * n_slices  # at one row a thread
    rows = 1 if warps < 4096 else 4 if name == "tc_bwd_dmu" and warps >= 8192 else 2
    return BackwardPlan(rows, slice_len, n_slices)


class ForwardPlan(NamedTuple):
    slice_len: int
    n_slices: int
    latents: int     # latents a lane holds: l = lane, lane + 32, ...


def forward_plan(b_i: int, zdim: int) -> ForwardPlan:
    """How ``tc_fwd`` sums against a bank of ``b_i`` rows: the bank cut as
    ``reduce_slices`` cuts it, one warp a slice, and Z spread over the lanes
    of each warp. A function of the bank's length and Z alone, never of the
    rows or ``row_off``: so a rank's pm and qz are summed in the
    single-device kernel's order. The launcher is given the cut and refuses
    any other; the lanes' latents follow from Z in the kernel."""
    return ForwardPlan(*reduce_slices(b_i), -(-zdim // 32))


def scratch_bytes(b: int, global_batch: int, zdim: int) -> int:
    """Bytes of float64 the forward keeps for the backward: psum
    [b, global_batch], terms [b, zdim, 4] and lj [b]."""
    return 8 * (b * global_batch + 4 * b * zdim + b)


def launch(name: str, tensors, b_j: int, b_i: int, zdim: int,
           dataset_size: int, device: torch.device, row_off: int = 0,
           plan: ForwardPlan | BackwardPlan | None = None) -> None:
    """One kernel launch: b_j z rows (rows row_off.. of the global batch)
    against b_i mu rows, the whole bank, so the global batch whose weights
    apply is b_i. The forward takes ``forward_plan``'s cut and a backward
    kernel ``backward_plan``'s launch, unless ``plan`` gives another (the
    forward refuses any other cut, a backward kernel one of other slices)."""
    if plan is None:
        plan = (forward_plan(b_i, zdim) if name == "tc_fwd"
                else backward_plan(name, b_j, b_i, zdim))
    if name == "tc_fwd":
        plan = plan[:2]  # the cut
    cuda_build.launch(LIBRARY, name, *tensors, b_j, b_i, zdim, int(dataset_size),
                      int(row_off), b_i, *plan, device=device, counts=LAUNCHES)


def launch_empty(device: torch.device) -> None:
    """An empty kernel on the current stream: what a launch costs."""
    cuda_build.launch(LIBRARY, "tc_empty", device=device)


def forward_buffers(b: int, global_batch: int, zdim: int, device: torch.device):
    """(terms [b, zdim, 4], psum [b, global_batch], lj [b]), float64: what
    tc_fwd writes for the backward kernels. Raises if the device cannot hold
    them; nothing else computes the op."""
    f64 = dict(device=device, dtype=torch.float64)
    try:
        return (torch.empty((b, zdim, 4), **f64), torch.empty((b, global_batch), **f64),
                torch.empty(b, **f64))
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"the TC kernels keep sum_l P[j, i, l] for the backward, a float64 "
            f"[{b}, {global_batch}] scratch: {scratch_bytes(b, global_batch, zdim):,} "
            f"bytes with the per-row terms, which {device} cannot allocate"
        ) from e


def _check(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
           row_off: int, dataset_size: int, global_batch: int) -> None:
    for name, t in (("z", z), ("mu", mu), ("logvar", logvar)):
        if t.device != z.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernels take CUDA "
                             f"tensors on one device (z is on {z.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernels take float32")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    b_j, zdim = z.shape
    if logvar.shape != z.shape or mu.shape != (global_batch, zdim):
        raise ValueError(f"shapes z {tuple(z.shape)}, mu {tuple(mu.shape)}, "
                         f"logvar {tuple(logvar.shape)} must be [B, Z], "
                         f"[{global_batch}, Z], [B, Z]")
    if global_batch < 2 or zdim > 1024:
        raise ValueError(f"the kernels take a global batch >= 2 and Z <= 1024, got "
                         f"{global_batch}, Z={zdim}")
    if not 0 <= row_off <= global_batch - b_j:
        raise ValueError(f"rows [{row_off}, {row_off + b_j}) lie outside the global "
                         f"batch of {global_batch}")
    if dataset_size < global_batch:
        raise ValueError(f"dataset_size {dataset_size} < batch {global_batch}: the "
                         "stratified weights need N >= B")


class _TCLogsumexp(torch.autograd.Function):
    """z, logvar [B, Z] (rows row_off.. of the global batch) against the
    mu bank [GB, Z]; GB = B and row_off = 0 on one device."""

    @staticmethod
    def forward(ctx, z, mu, logvar, row_off: int, dataset_size: int):
        b, zdim = z.shape
        gb = mu.shape[0]
        # float64, kept for the backward (precision note in
        # csrc/tc_kernels.cu); the outputs are float32
        terms, psum, lj = forward_buffers(b, gb, zdim, z.device)
        pm = torch.empty(b, device=z.device, dtype=torch.float32)
        qz = torch.empty(b, device=z.device, dtype=torch.float32)
        launch("tc_fwd", (z, mu, logvar, terms, psum, lj, pm, qz), b, gb, zdim,
               dataset_size, z.device, row_off)
        ctx.save_for_backward(mu, logvar, terms, psum, lj)
        ctx.row_off, ctx.dataset_size = row_off, dataset_size
        return pm, qz

    @staticmethod
    def backward(ctx, g_pm, g_qz):
        with launch_counts.host_range("itcvae::tc_logsumexp_backward"):
            return _TCLogsumexp._backward(ctx, g_pm, g_qz)

    @staticmethod
    def _backward(ctx, g_pm, g_qz):
        mu, logvar, terms, psum, lj = ctx.saved_tensors
        b, zdim = logvar.shape
        gb = mu.shape[0]
        # grads of (sum_l lm, lj): g_pm reaches every lm[j, l] (broadcast
        # over l inside the kernel, as _tc_bwd does)
        g_m = g_pm.float().contiguous()
        g_j = g_qz.float().contiguous()
        dz = torch.empty_like(logvar)
        dlogvar = torch.empty_like(logvar)
        dmu = torch.empty_like(mu)  # the whole bank
        launch("tc_bwd_dz", (terms, mu, logvar, psum, lj, g_m, g_j, dz, dlogvar),
               b, gb, zdim, ctx.dataset_size, logvar.device, ctx.row_off)
        launch("tc_bwd_dmu", (terms, mu, psum, lj, g_m, g_j, dmu),
               b, gb, zdim, ctx.dataset_size, logvar.device, ctx.row_off)
        return dz, dmu, dlogvar, None, None


def tc_logsumexp_reference(z: torch.Tensor, mu: torch.Tensor,
                           logvar: torch.Tensor, dataset_size: int):
    """Plain version: materialize the [B, B, z] log densities (floor and
    clamp included) and reduce with ``torch.logsumexp``; autograd gives
    the gradient (``torch.clamp`` passes none below -50)."""
    log_qz_prob = gaussian_log_density_nll(
        z[:, None, :], mu[None, :, :], logvar[:, None, :]
    )
    return minibatch_stratified_sampling(log_qz_prob, z.shape[0], dataset_size)


def tc_logsumexp_reference_gathered(z: torch.Tensor, mu_bank: torch.Tensor,
                                    logvar: torch.Tensor, row_off: int,
                                    dataset_size: int, global_batch: int):
    """Plain version of the gathered form: the [B, GB, z] log densities of
    the rank's rows against the whole bank, weighted with rows row_off..
    of the global weight matrix (``log_importance_weight_block``)."""
    log_qz_prob = gaussian_log_density_nll(
        z[:, None, :], mu_bank[None, :, :], logvar[:, None, :]
    )
    log_iw = log_importance_weight_block(row_off, z.shape[0], global_batch,
                                         dataset_size, z.device)
    logqz_prodmarginals = torch.logsumexp(
        log_iw[:, :, None] + log_qz_prob, dim=1
    ).sum(dim=1)
    log_qz = torch.logsumexp(log_iw + log_qz_prob.sum(dim=2), dim=1)
    return logqz_prodmarginals, log_qz


def tc_plain_intermediates(z: torch.Tensor, mu_bank: torch.Tensor,
                           logvar: torch.Tensor, row_off: int, dataset_size: int) -> dict:
    """The plain quantities of rows row_off.. of the global batch against the
    whole bank, materialised in the inputs' dtype: ``d`` = z - mu and ``q`` =
    d / v [B, GB, Z], the ``raw`` and clamped (``p``) log densities, the
    log-weights ``iw`` [B, GB], ``lm`` [B, Z] and ``lj`` [B] by
    ``torch.logsumexp``, and ``psum`` [B, GB] = sum_l P."""
    var = torch.clamp(torch.exp(logvar), min=VAR_FLOOR)[:, None, :]
    d = z[:, None, :] - mu_bank[None, :, :]
    q = d / var
    raw = -0.5 * (torch.log(var) + d * q + LOG_2PI)
    p = torch.clamp(raw, min=LOG_PROB_FLOOR)
    iw = log_importance_weight_block(row_off, z.shape[0], mu_bank.shape[0],
                                     dataset_size, z.device).to(z.dtype)
    psum = p.sum(dim=2)
    return dict(d=d, q=q, raw=raw, p=p, iw=iw, psum=psum,
                lm=torch.logsumexp(iw[:, :, None] + p, dim=1),
                lj=torch.logsumexp(iw + psum, dim=1))


class ForwardSplit(NamedTuple):
    psum: torch.Tensor       # [B, GB]
    lm: torch.Tensor         # [B, Z]
    lj: torch.Tensor         # [B]
    pm: torch.Tensor         # [B]
    qz: torch.Tensor         # [B]: lj, which the kernel also writes in float32
    exponents: torch.Tensor  # [B, GB, Z]: the marginal's shifted exponents


def _sum_in_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def tc_forward_split_reference(z: torch.Tensor, mu_bank: torch.Tensor,
                               logvar: torch.Tensor, row_off: int,
                               dataset_size: int) -> ForwardSplit:
    """psum, lm, lj, pm and qz as ``tc_fwd`` computes them, written out with
    plain tensor ops in the inputs' dtype, for rows row_off.. of the global
    batch against the whole bank, in ``forward_plan``'s order:

    * psum: each lane's latents in order, then the lanes of a warp pairwise
      across lane bits 16, 8, 4, 2 and 1 (the kernel's halving);
    * lm: exp of iw + P less the fixed shift log(1/M), summed over each
      slice of the bank, the slices in ascending order; the ``exponents``
      lie in [-50 - log N, 3.69];
    * lj: each slice's max of iw + psum and its sum of exp(x - max), then
      the slices in ascending order against their largest max."""
    b, zdim = z.shape
    gb = mu_bank.shape[0]
    plan = forward_plan(gb, zdim)
    e = torch.exp(logvar)
    floored = ~(e > VAR_FLOOR)
    a = -0.5 * (1.0 / torch.where(floored, torch.full_like(e, VAR_FLOOR), e))
    c = -0.5 * (torch.where(floored, torch.full_like(e, math.log(VAR_FLOOR)), logvar)
                + LOG_2PI)
    d = z[:, None, :] - mu_bank[None, :, :]
    p = torch.clamp(d * a[:, None, :] * d + c[:, None, :], min=LOG_PROB_FLOOR)

    lanes = F.pad(p, (0, 32 * plan.latents - zdim)).reshape(b, gb, plan.latents, 32)
    s = _sum_in_order(lanes.unbind(2))
    for half in (16, 8, 4, 2, 1):
        s = s[..., :half] + s[..., half:2 * half]
    psum = s[..., 0]

    iw = log_importance_weight_block(row_off, b, gb, dataset_size, z.device).to(z.dtype)
    log1m = float(torch.tensor(math.log(1.0 / (gb - 1)), dtype=torch.float32))
    x = p + (iw - log1m)[:, :, None]
    lm = torch.log(_sum_in_order([part.sum(1) for part in
                                  torch.exp(x).split(plan.slice_len, 1)])) + log1m

    xj = (iw + psum).split(plan.slice_len, 1)
    maxes = [part.max(1).values for part in xj]
    m = torch.stack(maxes, 1).max(1).values
    sj = _sum_in_order([torch.exp(part - mx[:, None]).sum(1) * torch.exp(mx - m)
                        for part, mx in zip(xj, maxes)])
    lj = m + torch.log(sj)
    return ForwardSplit(psum, lm, lj, lm.sum(1), lj, x)


def tc_backward_split_reference(z: torch.Tensor, mu_bank: torch.Tensor,
                                logvar: torch.Tensor, g_m: torch.Tensor,
                                g_j: torch.Tensor, dataset_size: int,
                                row_off: int = 0):
    """(dz, dlogvar, dmu) of g_m . pm + g_j . qz as the backward kernels
    compute them, written out with plain tensor ops: the [B, GB, z] densities
    and their incoming gradient dP, then every sum over the reduced axis (i
    for dz and dlogvar, j for dmu) as partial sums over ``reduce_slices``'
    slices added in ascending order. In the inputs' dtype."""
    t = tc_plain_intermediates(z, mu_bank, logvar, row_off, dataset_size)
    d, q, iw, p = t["d"], t["q"], t["iw"], t["p"]
    joint = g_j[:, None] * torch.exp(iw + t["psum"] - t["lj"][:, None])
    dp = g_m[:, None, None] * torch.exp(iw[:, :, None] + p - t["lm"][:, None, :]) + joint[:, :, None]
    dp = torch.where(t["raw"] > LOG_PROB_FLOOR, dp, torch.zeros_like(dp))

    def sum_slices(x, dim):
        return _sum_in_order([part.sum(dim) for part in
                              x.split(reduce_slices(x.shape[dim])[0], dim)])

    dz = sum_slices(-dp * q, 1)
    dlogvar = 0.5 * sum_slices(dp * (d * q - 1.0), 1)
    dlogvar = torch.where(torch.exp(logvar) > VAR_FLOOR, dlogvar, torch.zeros_like(dlogvar))
    return dz, dlogvar, sum_slices(dp * q, 0)


def tc_logsumexp_cuda(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
                      dataset_size: int):
    """(log prod_l q(z_l) [B], log q(z) [B]) via the CUDA kernels.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    or raise.
    """
    if all(t.device.type == "cpu" for t in (z, mu, logvar)):
        return tc_logsumexp_reference(z, mu, logvar, dataset_size)
    with launch_counts.host_range("itcvae::tc_logsumexp"):
        _check(z, mu, logvar, 0, dataset_size, z.shape[0])
        CALLS["tc_logsumexp"] += 1
        return _TCLogsumexp.apply(z, mu, logvar, 0, int(dataset_size))


def tc_logsumexp_cuda_gathered(z: torch.Tensor, mu_bank: torch.Tensor,
                               logvar: torch.Tensor, row_off: int,
                               dataset_size: int, global_batch: int):
    """This rank's (log prod_l q(z_l), log q(z)) [B_local] against the
    all-gathered mu bank [global_batch, Z], its rows being rows
    row_off.. of the global batch; the gradient of mu_bank is the whole
    bank's (the counterpart of ``tc_logsumexp_pallas_gathered``).

    CPU tensors take the plain version; CUDA tensors launch the kernels
    or raise.
    """
    if all(t.device.type == "cpu" for t in (z, mu_bank, logvar)):
        return tc_logsumexp_reference_gathered(z, mu_bank, logvar, row_off,
                                               dataset_size, global_batch)
    with launch_counts.host_range("itcvae::tc_logsumexp_gathered"):
        _check(z, mu_bank, logvar, int(row_off), dataset_size, global_batch)
        CALLS["tc_logsumexp_gathered"] += 1
        return _TCLogsumexp.apply(z, mu_bank, logvar, int(row_off), int(dataset_size))
