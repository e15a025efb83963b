"""The host side of the TC backward kernels: how the reduced axis is cut
(``tc_cuda.reduce_slices``), the launch (``backward_plan``), the scratch
the forward keeps (``scratch_bytes``, ``forward_buffers``), and the plain
PyTorch version that sums in the kernels' split order
(``tc_backward_split_reference``).

The split version is held to autograd of ``tc_logsumexp_reference`` in
float64, where only the order of the sums differs (rtol 1e-10, atol 1e-12:
sums of up to 256 terms of size up to ~1e3 that cancel), and through it, in
float32, to the JAX ``tc_logsumexp_pallas`` kernels in interpret mode at
rtol 1e-4 / atol 1e-5, as tests/test_torch_ops.py holds the wrappers.
"""

import jax
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.ops import tc_pallas
from intro_tc_vae_tpu_torch.ops import tc_cuda

TC = dict(rtol=1e-4, atol=1e-5)
ORDER = dict(rtol=1e-10, atol=1e-12)
LENGTHS = [1, 2, 3, 7, 8, 9, 16, 37, 40, 64, 90, 127, 128, 129, 200, 256, 512, 2048, 2049,
           16384]


@pytest.mark.parametrize("n_red", LENGTHS)
def test_reduce_slices_cover_the_axis_once(n_red):
    """Slices of one length, a multiple of 8, at most 16 of them, none
    empty, the last one possibly short: what the kernels' launchers check
    before they launch."""
    slice_len, n_slices = tc_cuda.reduce_slices(n_red)
    assert slice_len % 8 == 0 and slice_len >= tc_cuda.MIN_SLICE_LEN
    assert 1 <= n_slices <= tc_cuda.MAX_SLICES
    assert slice_len * (n_slices - 1) < n_red <= slice_len * n_slices
    if n_red <= tc_cuda.MAX_SLICES * tc_cuda.MIN_SLICE_LEN:
        assert slice_len == tc_cuda.MIN_SLICE_LEN  # short chains while latency bounds
    else:
        assert n_slices == -(-n_red // slice_len) and slice_len - 8 < n_red / 16 <= slice_len


@pytest.mark.parametrize("b_j,b_i,zdim", [(64, 64, 128), (64, 128, 128), (16, 128, 128),
                                          (40, 40, 72), (37, 90, 72), (3, 3, 5),
                                          (512, 512, 128), (2048, 2048, 128),
                                          (2048, 16384, 1024), (16384, 16384, 10)])
def test_backward_plan_changes_no_sum(b_j, b_i, zdim):
    """The slices of a plan follow from the reduced length alone: i (the
    bank) for tc_bwd_dz, j for tc_bwd_dmu. Neither the number of output
    rows, Z nor the rows a thread takes moves them, so a rank's dz rows are
    summed in the single-device kernel's order. The rows a thread takes are
    among those the kernels are built for."""
    dz = tc_cuda.backward_plan("tc_bwd_dz", b_j, b_i, zdim)
    dmu = tc_cuda.backward_plan("tc_bwd_dmu", b_j, b_i, zdim)
    assert (dz.slice_len, dz.n_slices) == tc_cuda.reduce_slices(b_i)
    assert (dmu.slice_len, dmu.n_slices) == tc_cuda.reduce_slices(b_j)
    assert dz.rows in (1, 2) and dmu.rows in (1, 2, 4)
    for other_rows, other_z in ((1, zdim), (b_j + 5, 1024), (16384, 32)):
        assert tc_cuda.backward_plan("tc_bwd_dz", other_rows, b_i, other_z)[1:] == dz[1:]
        assert tc_cuda.backward_plan("tc_bwd_dmu", b_j, other_rows, other_z)[1:] == dmu[1:]
    # a block: one warp a slice, at most 512 threads; its partial sums in
    # shared memory (one double per thread, row and sum) and the 16 warps'
    # tables of joint weights (32 doubles per row; tc_bwd_dmu one more for
    # g_m) fit the 48 KB a kernel gets without asking
    for plan, sums, extra in ((dz, 2, 0), (dmu, 1, 1)):
        assert plan.n_slices * 32 <= 512
        partials = plan.n_slices * 32 * plan.rows * sums
        tables = tc_cuda.MAX_SLICES * (plan.rows + extra) * 32
        assert (partials + tables) * 8 <= 48 * 1024


def test_backward_plan_takes_more_rows_as_the_batch_grows():
    rows = [(tc_cuda.backward_plan("tc_bwd_dz", b, b, 128).rows,
             tc_cuda.backward_plan("tc_bwd_dmu", b, b, 128).rows)
            for b in (16, 64, 128, 512, 2048, 16384)]
    assert rows[0] == (1, 1) and rows[1] == (1, 1)  # the training shape: one row
    assert rows[-1] == (2, 4)
    assert rows == sorted(rows)


@pytest.mark.parametrize("b,gb,zdim,psum_bytes", [(64, 64, 128, 32 * 1024),
                                                  (64, 128, 128, 64 * 1024),
                                                  (16384, 16384, 128, 2 ** 31)])
def test_scratch_is_quadratic_in_the_batch_only(b, gb, zdim, psum_bytes):
    """psum [b, gb] float64 plus the per-row terms [b, Z, 4] and lj [b]:
    O(B^2 + B Z), never the O(B^2 Z) tensor."""
    total = tc_cuda.scratch_bytes(b, gb, zdim)
    assert total == psum_bytes + 32 * b * zdim + 8 * b
    terms, psum, lj = tc_cuda.forward_buffers(min(b, 64), min(gb, 128), zdim,
                                              torch.device("cpu"))
    assert (terms.shape, psum.shape, lj.shape) == (
        (min(b, 64), zdim, 4), (min(b, 64), min(gb, 128)), (min(b, 64),))
    assert {t.dtype for t in (terms, psum, lj)} == {torch.float64}
    assert sum(t.numel() * 8 for t in (terms, psum, lj)) == tc_cuda.scratch_bytes(
        min(b, 64), min(gb, 128), zdim)


def _inputs(gb, zdim, seed):
    """As tests/test_torch_ops.py: variance floor and -50 clamp active."""
    rng = np.random.RandomState(seed)
    z = rng.randn(gb, zdim).astype(np.float32)
    mu = rng.randn(gb, zdim).astype(np.float32)
    logvar = (rng.randn(gb, zdim) * 0.7 * 4.0).astype(np.float32)
    logvar[::3, ::2] = -12.0
    return z, mu, logvar


def _incoming(b, gb, dtype):
    """g_m, g_j of tc_loss = (qz - pm).sum() / gb + 0.5e-3 pm.sum(), plus a
    slope so that rows differ."""
    slope = torch.linspace(0.5, 1.5, b, dtype=dtype)
    return (-1.0 / gb + 5e-4) * slope, slope / gb


# (rows, row_off, bank, Z): the single-device form at one slice, at ragged
# slices and at 16 slices of 16; the gathered form with a short last slice
SHAPES = [(8, 0, 8, 8), (40, 0, 40, 72), (37, 5, 90, 72), (16, 112, 128, 16),
          (64, 0, 64, 16), (200, 0, 200, 5), (3, 0, 3, 5), (130, 0, 130, 4), (32, 100, 256, 6)]


@pytest.mark.parametrize("b,off,gb,zdim", SHAPES)
def test_split_reference_matches_autograd_in_float64(b, off, gb, zdim):
    z, mu, logvar = (torch.tensor(a, dtype=torch.float64) for a in _inputs(gb, zdim, gb))
    n = 20 * gb
    g_m, g_j = _incoming(b, gb, torch.float64)
    args = [t.clone().requires_grad_(True) for t in (z[off:off + b], mu, logvar[off:off + b])]
    pm, qz = tc_cuda.tc_logsumexp_reference_gathered(*args, off, n, gb)
    want = torch.autograd.grad((g_m * pm).sum() + (g_j * qz).sum(), args)
    dz, dlogvar, dmu = tc_cuda.tc_backward_split_reference(
        z[off:off + b], mu, logvar[off:off + b], g_m, g_j, n, row_off=off)
    assert dmu.shape == (gb, zdim)  # the whole bank
    for got, ref in zip((dz, dmu, dlogvar), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **ORDER)
    floored = torch.exp(logvar[off:off + b]) <= 1e-4
    assert floored.any() and not dlogvar[floored].any()


def test_split_reference_sums_slice_by_slice(monkeypatch):
    """At 37 rows against a bank of 90 the bank is cut into 12 slices of 8
    (the last of 2), the rows into 5. Summing each slice first and the
    slices in ascending order rounds, in float32, otherwise than one sum
    over the whole axis (the same function with one slice): the order is
    the cut's, and it stays within float32 rounding of the one sum."""
    b, off, gb, zdim = 37, 5, 90, 72
    assert tc_cuda.reduce_slices(gb) == (8, 12) and tc_cuda.reduce_slices(b) == (8, 5)
    z, mu, logvar = (torch.tensor(a) for a in _inputs(gb, zdim, gb))
    args = (z[off:off + b], mu, logvar[off:off + b], *_incoming(b, gb, torch.float32), 1800)
    split = tc_cuda.tc_backward_split_reference(*args, row_off=off)
    monkeypatch.setattr(tc_cuda, "reduce_slices", lambda n_red: (n_red, 1))
    whole = tc_cuda.tc_backward_split_reference(*args, row_off=off)
    for got, want in zip(split, whole):
        assert not torch.equal(got, want)
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("b,zdim,n", [(8, 8, 64), (32, 16, 5000), (40, 24, 1280)])
def test_split_reference_matches_jax_pallas_interpret(b, zdim, n):
    """float32, against the gradients of the JAX Pallas kernels in interpret
    mode with the same incoming g_m, g_j."""
    from jax.experimental.pallas import tpu as pltpu

    z, mu, logvar = _inputs(b, zdim, b + zdim)
    g_m, g_j = _incoming(b, b, torch.float32)

    def loss(a, m, l):
        pm, qz = tc_pallas.tc_logsumexp_pallas(a, m, l, n)
        return (g_m.numpy() * pm).sum() + (g_j.numpy() * qz).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(z, mu, logvar)
    dz, dlogvar, dmu = tc_cuda.tc_backward_split_reference(
        *(torch.tensor(a) for a in (z, mu, logvar)), g_m, g_j, n)
    for got, want in zip((dz, dmu, dlogvar), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TC)


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 0), (8, 5)])
def test_split_reference_matches_jax_pallas_gathered_interpret(world, rank):
    """The gathered form: a rank's rows against the whole bank (B = 32,
    Z = 16, N = 5000), the bank's gradient included."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    gb, zdim, n = 32, 16, 5000
    z, mu, logvar = _inputs(gb, zdim, 7)
    b = gb // world
    off = rank * b
    rows = slice(off, off + b)
    g_m, g_j = _incoming(b, gb, torch.float32)

    def loss(a, m, l):
        pm, qz = tc_pallas.tc_logsumexp_pallas_gathered(a, m, l, jnp.int32(off), n, gb)
        return (g_m.numpy() * pm).sum() + (g_j.numpy() * qz).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(z[rows], mu, logvar[rows])
    dz, dlogvar, dmu = tc_cuda.tc_backward_split_reference(
        *(torch.tensor(a) for a in (z[rows], mu, logvar[rows])), g_m, g_j, n, row_off=off)
    assert dmu.shape == (gb, zdim)
    for got, want in zip((dz, dmu, dlogvar), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TC)


# ---- the forward: forward_plan and tc_forward_split_reference ----

FORWARD_PLANS = [(1, 1), (3, 5), (40, 72), (90, 33), (64, 128), (128, 128), (200, 129),
                 (512, 160), (2048, 128), (16384, 1024), (9, 1024)]


@pytest.mark.parametrize("b_i,zdim", FORWARD_PLANS)
def test_forward_plan_depends_on_the_bank_and_z_only(b_i, zdim):
    """The bank is cut as the backward kernels cut it (``reduce_slices``),
    whatever the rows, in slices of whole chunks of 8 rows up to the bank's
    end; a lane takes the latents lane, lane + 32, ...: every latent in
    exactly one (group, lane), the slots past Z in the last group only. One
    warp a slice: a block is at most 512 threads, and its shared memory (the
    row's latents, 3 doubles each, every slice's marginal sums and its ring
    of 2 stages of 8 x 32 floats of mu, and the 48 doubles of its joint and
    pm partials) fits the 227 KB a block can have."""
    plan = tc_cuda.forward_plan(b_i, zdim)
    assert (plan.slice_len, plan.n_slices) == tc_cuda.reduce_slices(b_i)
    assert plan.slice_len % 8 == 0
    cover = sorted(32 * g + lane for g in range(plan.latents) for lane in range(32))
    assert cover == list(range(32 * plan.latents)) and 0 <= 32 * plan.latents - zdim < 32
    assert plan.n_slices * 32 <= 512
    shared = 32 * plan.latents * (3 * 8 + plan.n_slices * 8) + plan.n_slices * 2 * 8 * 32 * 4
    assert shared + 48 * 8 <= 232_448


def test_forward_plan_at_the_shapes_the_port_runs():
    assert tc_cuda.forward_plan(64, 128) == (8, 8, 4)      # the training shape
    assert tc_cuda.forward_plan(128, 128) == (8, 16, 4)    # the gathered bank of dp8
    assert tc_cuda.forward_plan(512, 128) == (32, 16, 4)
    assert tc_cuda.forward_plan(2048, 128) == (128, 16, 4)
    assert tc_cuda.forward_plan(2048, 160) == (128, 16, 5)
    assert tc_cuda.forward_plan(64, 32) == (8, 8, 1)
    assert tc_cuda.forward_plan(64, 1024) == (8, 8, 32)


def _inputs64(gb, zdim, seed, logvar=None):
    """_inputs in float64; logvar all one value where given."""
    z, mu, lv = (torch.tensor(a, dtype=torch.float64) for a in _inputs(gb, zdim, seed))
    if logvar is not None:
        lv = torch.full_like(lv, logvar)
    return z, mu, lv


def _check_forward(b, off, gb, zdim, n, logvar=None):
    """The split forward against the materialised plain version: psum and lm
    at rtol 1e-12 (atol 1e-12 for entries near 0), lj, pm and qz against the
    plain gathered version; every shifted exponent in [-50 - log N, 3.69]."""
    z, mu, lv = _inputs64(gb, zdim, gb + zdim, logvar)
    z, lv = z[off:off + b], lv[off:off + b]
    got = tc_cuda.tc_forward_split_reference(z, mu, lv, off, n)
    plain = tc_cuda.tc_plain_intermediates(z, mu, lv, off, n)
    pm, qz = tc_cuda.tc_logsumexp_reference_gathered(z, mu, lv, off, n, gb)
    assert got.psum.shape == (b, gb) and got.lm.shape == (b, zdim)
    for key, value in got._asdict().items():
        assert torch.isfinite(value).all(), key
    for g, w in ((got.psum, plain["psum"]), (got.lm, plain["lm"]), (got.lj, plain["lj"]),
                 (got.pm, pm), (got.qz, qz)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
    x = got.exponents
    assert float(x.max()) <= -0.5 * (np.log(1e-4) + np.log(2 * np.pi))  # 3.686: v >= 1e-4
    assert float(x.min()) >= -50.0 - np.log(n) - 1e-5  # float32 weights
    assert float(x.min()) > -94.0
    return got


# (rows, row_off, bank, Z, N): ragged Z (5, 33, 72) and banks that are no
# multiple of a slice; Z = 1024 (8 passes); a rank's rows
FORWARD_SHAPES = [(3, 0, 3, 5, 60), (20, 0, 20, 33, 400), (40, 0, 40, 72, 800),
                  (37, 5, 90, 72, 1800), (200, 0, 200, 16, 4000), (16, 3, 40, 1024, 800),
                  (9, 0, 9, 160, 180)]


@pytest.mark.parametrize("b,off,gb,zdim,n", FORWARD_SHAPES)
def test_forward_split_reference_matches_the_materialised_plain_version(b, off, gb, zdim, n):
    _check_forward(b, off, gb, zdim, n)


@pytest.mark.parametrize("logvar,n,what", [
    (100.0, 400, "c < -50: every P clamps and chat = -50"),
    (-40.0, 400, "every variance floored"),
    (None, 10 ** 15, "N = 1e15: log(1/N) far under log(1/M)"),
    (None, 20, "N = B_i: N - M = 1, the stratified weight at its least"),
], ids=["clamped", "floored", "n1e15", "n_eq_b"])
def test_forward_split_reference_at_extreme_inputs(logvar, n, what):
    got = _check_forward(20, 0, 20, 33, n, logvar)
    if logvar == 100.0:
        assert torch.all(got.exponents[:, 2:] == -50.0)  # P = -50 everywhere
        assert torch.all(got.psum == -50.0 * 33)


def test_forward_split_reference_reaches_both_ends_of_the_exponents():
    """Both ends are reached: a clamped density with the weight log(1/N) of
    column 0 gives -50 - log(N/M); a floored variance at d = 0 gives
    -0.5 (log 1e-4 + log 2 pi) = 3.69."""
    gb, n = 16, 10 ** 15
    got = _check_forward(gb, 0, gb, 8, n, logvar=-40.0)
    np.testing.assert_allclose(float(got.exponents.min()), -50.0 - np.log(n / (gb - 1)),
                               rtol=1e-6)
    z, mu, lv = _inputs64(gb, 8, 3, logvar=-40.0)
    top = tc_cuda.tc_forward_split_reference(mu.clone(), mu, lv, 0, n).exponents.max()
    np.testing.assert_allclose(float(top), -0.5 * (np.log(1e-4) + np.log(2 * np.pi)),
                               rtol=1e-12)


@pytest.mark.parametrize("b,zdim,n", [(8, 8, 64), (32, 16, 5000), (24, 5, 480), (12, 33, 240)])
def test_forward_split_reference_matches_jax_pallas_interpret(b, zdim, n):
    """float64 against the JAX Pallas forward in interpret mode (float32
    inside): pm and qz, rtol 1e-4 / atol 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    z, mu, logvar = _inputs(b, zdim, b + zdim)
    with pltpu.force_tpu_interpret_mode():
        pm, qz = tc_pallas.tc_logsumexp_pallas(z, mu, logvar, n)
    got = tc_cuda.tc_forward_split_reference(
        *(torch.tensor(a, dtype=torch.float64) for a in (z, mu, logvar)), 0, n)
    np.testing.assert_allclose(got.pm.numpy(), np.asarray(pm), **TC)
    np.testing.assert_allclose(got.qz.numpy(), np.asarray(qz), **TC)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 1), (4, 3)])
def test_forward_split_reference_matches_jax_pallas_gathered_interpret(world, rank):
    """A rank's rows against the whole bank (B = 32, Z = 16, N = 5000): pm
    and qz against ``tc_logsumexp_pallas_gathered`` in interpret mode; the
    ranks' rows concatenated equal the single-device split rows bit for bit
    (the plan depends on the bank alone)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    gb, zdim, n = 32, 16, 5000
    z, mu, logvar = _inputs(gb, zdim, 7)
    b = gb // world
    off = rank * b
    rows = slice(off, off + b)
    with pltpu.force_tpu_interpret_mode():
        pm, qz = tc_pallas.tc_logsumexp_pallas_gathered(z[rows], mu, logvar[rows],
                                                        jnp.int32(off), n, gb)
    z64, mu64, lv64 = (torch.tensor(a, dtype=torch.float64) for a in (z, mu, logvar))
    got = tc_cuda.tc_forward_split_reference(z64[rows], mu64, lv64[rows], off, n)
    np.testing.assert_allclose(got.pm.numpy(), np.asarray(pm), **TC)
    np.testing.assert_allclose(got.qz.numpy(), np.asarray(qz), **TC)
    whole = tc_cuda.tc_forward_split_reference(z64, mu64, lv64, 0, n)
    for key in ("psum", "lm", "lj", "pm"):
        assert torch.equal(getattr(got, key), getattr(whole, key)[rows]), key
