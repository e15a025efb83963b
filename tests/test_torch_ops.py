"""PyTorch port vs JAX package: loss ops and the TC estimator.

Same numpy inputs (seeded) go through both packages in float32 on the
CPU. Tolerances: rtol 1e-5 / atol 1e-6 for elementwise ops (the same
formula in the same precision; only libm rounding differs), rtol 1e-4 /
atol 1e-5 for the TC logsumexps and their gradients (reductions over
B*z terms in another order), as tests/test_tc_impls.py uses for the
Pallas kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu import ops as jops
from intro_tc_vae_tpu.ops import tc_pallas
from intro_tc_vae_tpu.ops.tc import tc_logsumexp_blockwise as jtc_blockwise
from intro_tc_vae_tpu_torch import ops as tops
from intro_tc_vae_tpu_torch.ops import tc_cuda

EW = dict(rtol=1e-5, atol=1e-6)
TC = dict(rtol=1e-4, atol=1e-5)


def assert_close_scaled(got, want):
    """TC tolerance with atol taken relative to the largest entry: where
    the variance is floored at 1e-4, gradient terms reach ~1e3 and cancel
    in fp32 sums, so small entries carry an absolute error of that scale
    (JAX's own xla and Pallas gradients differ by as much)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _tc_inputs(rng, b, zdim):
    """z, mu, logvar with logvar scaled x4 (as tests/test_tc_impls.py:170)
    and a few entries below log(1e-4), so that both the variance floor
    and the -50 log-density clamp are active."""
    z = rng.randn(b, zdim).astype(np.float32)
    mu = rng.randn(b, zdim).astype(np.float32)
    logvar = (rng.randn(b, zdim) * 0.7 * 4.0).astype(np.float32)
    logvar[::3, ::2] = -12.0
    return z, mu, logvar


def _floor_and_clamp_active(z, mu, logvar):
    var = np.exp(logvar)
    lp = -0.5 * (np.log(np.maximum(var, 1e-4))[:, None]
                 + (z[:, None] - mu[None]) ** 2 / np.maximum(var, 1e-4)[:, None]
                 + np.log(2 * np.pi))
    return (var < 1e-4).any() and (lp < -50).any()


@pytest.mark.parametrize("density", ["nll", "plain"])
def test_gaussian_densities_match_jax(rng, density):
    x, mu, w = rng.randn(3, 16, 8).astype(np.float32)
    logvar = (rng.randn(16, 8) * 3.0).astype(np.float32)  # floor and clamp hit
    jf = jops.gaussian_log_density_nll if density == "nll" else jops.gaussian_log_density
    tf = tops.gaussian_log_density_nll if density == "nll" else tops.gaussian_log_density

    ref = jf(x, mu, logvar)
    ref_grads = jax.grad(lambda *a: jnp.sum(w * jf(*a)), argnums=(0, 1, 2))(x, mu, logvar)
    args = [_t(a, grad=True) for a in (x, mu, logvar)]
    out = tf(*args)
    torch.sum(_t(w) * out).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **EW)
    for a, g in zip(args, ref_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **EW)


@pytest.mark.parametrize("reduce", ["sum", "mean", "none"])
def test_kl_divergence_matches_jax(rng, reduce):
    logvar, mu = rng.randn(2, 16, 8).astype(np.float32)
    ref = jops.kl_divergence(jnp.asarray(logvar), jnp.asarray(mu), reduce=reduce)
    out = tops.kl_divergence(_t(logvar), _t(mu), reduce=reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EW)


@pytest.mark.parametrize("loss_type", ["mse", "l1", "bce"])
def test_reconstruction_loss_matches_jax(rng, loss_type):
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    recon = rng.uniform(0.01, 0.99, size=(4, 3, 8, 8)).astype(np.float32)
    for reduction in ("sum", "mean", "none"):
        # the JAX package is NHWC, the port NCHW: the per-sample sum is the same
        ref = jops.reconstruction_loss(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       jnp.asarray(recon.transpose(0, 2, 3, 1)),
                                       loss_type, reduction)
        out = tops.reconstruction_loss(_t(x), _t(recon), loss_type, reduction)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def test_reconstruction_target_is_detached(rng):
    x = _t(rng.rand(2, 3, 4, 4).astype(np.float32), grad=True)
    recon = _t(rng.rand(2, 3, 4, 4).astype(np.float32), grad=True)
    tops.reconstruction_loss(x, recon).backward()
    assert x.grad is None and recon.grad is not None


@pytest.mark.parametrize("b,n", [(8, 64), (64, 1280)])
def test_log_importance_weights_match_jax(b, n):
    ref = np.asarray(jops.log_importance_weight_matrix(b, n))
    out = tops.log_importance_weight_matrix(b, n, torch.device("cpu"))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("row_off,n_rows,col_off,n_cols,gb,n", [
    (0, 16, 0, 32, 32, 64), (16, 16, 0, 32, 32, 64), (24, 8, 8, 8, 32, 5000),
    (112, 16, 0, 128, 128, 1280), (96, 32, 64, 32, 128, 1280),
])
def test_log_importance_weight_block_matches_jax(row_off, n_rows, col_off, n_cols, gb, n):
    """Rows [row_off, +n_rows) and columns [col_off, +n_cols) of the
    global [GB, GB] log-weight matrix, generated from global indices,
    equal that block of the JAX matrix and the Pallas kernels' tile
    generator with row_off (tc_pallas.py:91), bit for bit. The blocks
    cover the special row M-1 = GB-2 and columns 0 and 1."""
    out = tops.log_importance_weight_block(row_off, n_rows, gb, n, torch.device("cpu"),
                                           col_off=col_off, n_cols=n_cols)
    full = np.asarray(jops.log_importance_weight_matrix(gb, n))
    np.testing.assert_array_equal(out.numpy(), full[row_off:row_off + n_rows,
                                                    col_off:col_off + n_cols])
    tile = tc_pallas._iw_block(0, col_off // n_cols, n_rows, n_cols,
                               tc_pallas._iw_consts(gb, n), row_off=row_off)
    np.testing.assert_array_equal(out.numpy(), np.asarray(tile))


def _tc_loss(pm, qz):
    """Weights the two outputs differently so both incoming gradients
    (g_m and g_j) are exercised, as tests/test_tc_impls.py does."""
    return (qz - pm).mean() + 0.5 * pm.sum() * 1e-3


@pytest.mark.parametrize("b,zdim,n", [(8, 8, 64), (32, 16, 5000)])
def test_tc_kernel_path_matches_jax_pallas_interpret(rng, b, zdim, n):
    """The port's impl='pallas' (plain version on CPU) against the JAX
    Pallas kernels in interpret mode: values and gradients."""
    from jax.experimental.pallas import tpu as pltpu

    z, mu, logvar = _tc_inputs(rng, b, zdim)
    assert _floor_and_clamp_active(z, mu, logvar)
    with pltpu.force_tpu_interpret_mode():
        (pm_ref, qz_ref) = tc_pallas.tc_logsumexp_pallas(z, mu, logvar, n)
        g_ref = jax.grad(
            lambda a, m, l: _tc_loss(*tc_pallas.tc_logsumexp_pallas(a, m, l, n)),
            argnums=(0, 1, 2),
        )(z, mu, logvar)

    args = [_t(a, grad=True) for a in (z, mu, logvar)]
    pm, qz = tc_cuda.tc_logsumexp_cuda(*args, n)
    _tc_loss(pm, qz).backward()
    np.testing.assert_allclose(pm.detach().numpy(), np.asarray(pm_ref), **TC)
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(qz_ref), **TC)
    for a, g in zip(args, g_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **TC)


@pytest.mark.parametrize("impl", ["xla", "pallas", "blockwise"])
@pytest.mark.parametrize("reduce", ["mean", "none"])
def test_total_correlation_matches_jax_xla(rng, impl, reduce):
    """Every port impl against JAX impl='xla', floor and clamp active."""
    b, zdim, n = 16, 8, 64
    z, mu, logvar = _tc_inputs(rng, b, zdim)
    assert _floor_and_clamp_active(z, mu, logvar)

    def jtc(a, m, l):
        return jops.total_correlation(a, m, l, n, reduce=reduce, impl="xla")

    ref = jtc(z, mu, logvar)
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.cos(jtc(*a))), argnums=(0, 1, 2))(
        z, mu, logvar)
    args = [_t(a, grad=True) for a in (z, mu, logvar)]
    out = tops.total_correlation(*args, n, reduce=reduce, impl=impl)
    torch.sum(torch.cos(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TC)
    for a, g in zip(args, g_ref):
        assert_close_scaled(a.grad.numpy(), g)


@pytest.mark.parametrize("kwargs", [dict(sampling="weighted")])
def test_total_correlation_options_match_jax(rng, kwargs):
    """The option that once raised, in float32 at the TC tolerance: the
    weighted estimate takes the materialized form whatever the impl, as in
    JAX (float64 at 1e-9 in tests/test_torch_solver_surface.py)."""
    z, mu, logvar = _tc_inputs(rng, 8, 4)
    ref = jops.total_correlation(z, mu, logvar, 64, reduce="none", **kwargs)
    for impl in ("xla", "pallas"):
        out = tops.total_correlation(_t(z), _t(mu), _t(logvar), 64, reduce="none",
                                     impl=impl, **kwargs)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TC)


@pytest.mark.parametrize("block", [8, 16, 32, 12])
def test_tc_blockwise_matches_jax_blockwise(rng, block):
    """The port's streaming loop against the JAX one (tests/test_tc_impls.py
    sizes: B=32, Z=16, N=5000; block 12 falls back to gcd(32, 12) = 4),
    values and gradients, floor and clamp active."""
    z, mu, logvar = _tc_inputs(rng, 32, 16)
    assert _floor_and_clamp_active(z, mu, logvar)
    n = 5000

    def jfn(a, m, l):
        return jtc_blockwise(a, m, l, n, block=block)

    pm_ref, qz_ref = jfn(z, mu, logvar)
    g_ref = jax.grad(lambda *a: _tc_loss(*jfn(*a)), argnums=(0, 1, 2))(z, mu, logvar)
    args = [_t(a, grad=True) for a in (z, mu, logvar)]
    pm, qz = tops.tc_logsumexp_blockwise(*args, n, block=block)
    _tc_loss(pm, qz).backward()
    np.testing.assert_allclose(pm.detach().numpy(), np.asarray(pm_ref), **TC)
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(qz_ref), **TC)
    for a, g in zip(args, g_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **TC)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3), (8, 5)])
def test_tc_gathered_matches_jax_pallas_gathered_interpret(rng, world, rank):
    """One rank's gathered TC (the port's kernel route, plain version on
    CPU) against ``tc_logsumexp_pallas_gathered`` in interpret mode: the
    rank's rows of z/logvar against the whole mu bank, rows weighted as
    rows row_off.. of the global batch; values and the gradients of z,
    logvar and the whole bank. B=32, Z=16, N=5000, floor and clamp on."""
    from jax.experimental.pallas import tpu as pltpu

    z, mu, logvar = _tc_inputs(rng, 32, 16)
    n, b = 5000, 32 // world
    rows = slice(rank * b, (rank + 1) * b)
    off = rank * b

    def jfn(a, m, l):
        return tc_pallas.tc_logsumexp_pallas_gathered(a, m, l, jnp.int32(off), n, 32)

    with pltpu.force_tpu_interpret_mode():
        pm_ref, qz_ref = jfn(z[rows], mu, logvar[rows])
        g_ref = jax.grad(lambda *a: _tc_loss(*jfn(*a)), argnums=(0, 1, 2))(
            z[rows], mu, logvar[rows])
    args = [_t(a, grad=True) for a in (z[rows], mu, logvar[rows])]
    pm, qz = tc_cuda.tc_logsumexp_cuda_gathered(*args, off, n, 32)
    _tc_loss(pm, qz).backward()
    assert args[1].grad.shape == (32, 16)  # the whole bank
    np.testing.assert_allclose(pm.detach().numpy(), np.asarray(pm_ref), **TC)
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(qz_ref), **TC)
    for a, g in zip(args, g_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **TC)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_tc_gathered_ranks_compose_to_one_device(rng, world):
    """Concatenated over the ranks, the gathered plain version's outputs
    equal the single-device plain version's, and its bank gradients
    summed over the ranks equal the single-device dmu (float64, so only
    the summation order differs)."""
    z, mu, logvar = (a.astype(np.float64) for a in _tc_inputs(rng, 32, 16))
    n, b = 5000, 32 // world
    full = [_t(a, grad=True) for a in (z, mu, logvar)]
    pm, qz = tc_cuda.tc_logsumexp_reference(*full, n)
    (qz - pm).sum().backward()
    outs, dmu = [], 0
    for r in range(world):
        rows = slice(r * b, (r + 1) * b)
        args = [_t(a, grad=True) for a in (z[rows], mu, logvar[rows])]
        pm_r, qz_r = tc_cuda.tc_logsumexp_reference_gathered(*args, r * b, n, 32)
        (qz_r - pm_r).sum().backward()
        outs.append(torch.stack([pm_r, qz_r], 1).detach())
        np.testing.assert_allclose(args[0].grad.numpy(), full[0].grad[rows].numpy(),
                                   rtol=1e-12, atol=1e-12)
        dmu = dmu + args[1].grad
    np.testing.assert_array_equal(torch.cat(outs).numpy(),
                                  torch.stack([pm, qz], 1).detach().numpy())
    np.testing.assert_allclose(dmu.numpy(), full[1].grad.numpy(), rtol=1e-10, atol=1e-10)
