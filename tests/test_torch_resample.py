"""PyTorch port: each stage's 2x2 average pool and nearest 2x upsample taken
into the BatchNorm call that ends the stage (``models/blocks.py``,
``models/vae.py``, ``ops/batchnorm_cuda.py::takes_resample``).

On the CPU the BatchNorm takes its plain version, and the resample runs
as the stock pass after it; with the kernels' route stood in for (the
route patched to "fused", the autograd function to the plain version
followed by the stock pass), the call takes the resample, as it does on
the card. Either way ``batchnorm_act_train``, ``GroupedBatchNorm`` and
the encoder and decoder give the bits of the wiring before the change
(the oracles below: the stock ``F.avg_pool2d`` / ``F.interpolate`` after
each stage's module), forward and backward, for every arch, ``remat``
mode and group count; and a step of each train cell's model counts its
resamples as the benchmark expects, all four in ``RESAMPLES``: those the
kernels take and those left to a stock pass. The kernels themselves:
``tests/test_torch_bn_cuda.py``, on the card.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch import bench
from intro_tc_vae_tpu_torch.models import Decoder, Encoder
from intro_tc_vae_tpu_torch.models.blocks import LEAKY_SLOPE, GroupedBatchNorm, remat
from intro_tc_vae_tpu_torch.ops import batchnorm as bn
from intro_tc_vae_tpu_torch.ops import batchnorm_cuda as bc
from tests._torch_threads import one_thread  # noqa: F401  (autouse)


def avg_pool2(x):
    return F.avg_pool2d(x, 2)


def upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


STOCK = {"pool": avg_pool2, "up": upsample_nearest2}
KEYS = ("resample_pool", "resample_up", "pool_stock", "up_stock")


def counted() -> dict:
    return {k: bc.RESAMPLES[k] for k in KEYS}


def delta(before: dict) -> dict:
    now = counted()
    return {k: now[k] - before[k] for k in KEYS}


class StandIn:
    """``_BatchNormAct`` as the CPU can run it: the plain version, then the
    stock pass of the resample the call was handed."""

    @staticmethod
    def apply(x, weight, bias, running, groups, eps, momentum, slope, resample=None):
        y = bn.batchnorm_act(x, weight, bias, running, groups, eps, momentum, slope, x.dtype)
        return y if resample is None else STOCK[resample](y)


@pytest.fixture
def kernels_route(monkeypatch):
    """Calls take the kernels' route (``route`` "fused"), run by ``StandIn``."""
    monkeypatch.setattr(bc, "route",
                        lambda x, group: "fused" if group is None else "plain_data_group")
    monkeypatch.setattr(bc, "_BatchNormAct", StandIn)


def meta(*shape):
    """A stand-in for a tensor on the card: the route reads its device."""
    return torch.empty(shape, device="meta")


# ---------------------------------------------------------------------------
# the decision
# ---------------------------------------------------------------------------

def test_takes_resample_by_what_the_call_observes():
    """On the kernels' route a pool of an even plane and an upsample of any
    plane are taken; an odd plane's pool, a CPU tensor, a data group, a
    tensor that is no [N, C, H, W] and no resample are not."""
    assert bc.takes_resample(meta(2, 4, 6, 8), "pool", None)
    assert bc.takes_resample(meta(2, 4, 5, 3), "up", None)
    for x, resample, group in ((meta(2, 4, 5, 6), "pool", None), (meta(2, 4, 6, 5), "pool", None),
                               (meta(2, 4, 6, 6), None, None), (meta(2, 4, 6, 6), "pool", object()),
                               (torch.ones(2, 4, 6, 6), "pool", None), (meta(2, 4, 36), "up", None)):
        assert not bc.takes_resample(x, resample, group), (tuple(x.shape), resample, group)


def test_the_cpu_route_runs_the_stock_pass_after_the_call():
    """``batchnorm_act_train`` with "pool" and "up" on CPU tensors (a route
    the kernels do not take a resample on): the plain call, then the stock
    pass, bit for bit, forward and backward, counted in ``pool_stock`` /
    ``up_stock``."""
    torch.manual_seed(3)
    x = torch.randn(4, 6, 6, 8) * 1.5 + 0.3
    w, b = torch.rand(6) * 0.4 + 0.8, torch.rand(6) * 0.2 - 0.1
    for resample, out in (("pool", (4, 6, 3, 4)), ("up", (4, 6, 12, 16))):
        dy = torch.randn(out)
        results = []
        for routed in (True, False):
            xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
            running = (torch.zeros(6), torch.ones(6))
            start = counted()
            if routed:
                y = bc.batchnorm_act_train(xr, wr, br, running, 2, 1e-4, 0.1, 0.2,
                                           torch.float32, None, resample)
                assert delta(start) == {k: int(k == f"{resample}_stock") for k in KEYS}
            else:
                y = STOCK[resample](bn.batchnorm_act(xr, wr, br, running, 2, 1e-4, 0.1, 0.2,
                                                     torch.float32))
            assert tuple(y.shape) == out
            results.append((y, *torch.autograd.grad(y, (xr, wr, br), dy), *running))
        for got, want in zip(*results):
            assert torch.equal(got, want), resample


def test_resampled_shape():
    x = meta(2, 4, 6, 10)
    assert bc.resampled_shape(x, None) == (2, 4, 6, 10)
    assert bc.resampled_shape(x, "pool") == (2, 4, 3, 5)
    assert bc.resampled_shape(x, "up") == (2, 4, 12, 20)


# ---------------------------------------------------------------------------
# GroupedBatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resample", ["pool", "up"])
@pytest.mark.parametrize("mode", ["plain", "kernels", "data_group", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_batchnorm_is_the_call_then_the_stock_pass(request, monkeypatch, resample, mode,
                                                           dtype):
    """``GroupedBatchNorm(x, groups, slope, resample)`` against the module
    without it followed by the stock pass: output, gradients and running
    statistics bit for bit; the kernels' route counts the resample taken,
    every other route the stock pass."""
    if mode == "kernels":
        request.getfixturevalue("kernels_route")
    if mode == "data_group":
        monkeypatch.setattr(bc, "all_reduce_sum", lambda t, mesh: t)
    torch.manual_seed(0)
    module = GroupedBatchNorm(6, eps=1e-4, compute_dtype=dtype).train(mode != "eval")
    with torch.no_grad():
        module.weight.uniform_(0.8, 1.2)
        module.bias.uniform_(-0.1, 0.1)
        module.running_var.uniform_(0.5, 2.0)
    if mode == "data_group":
        module.data_group = object()
    before = copy.deepcopy(module)
    x = (torch.randn(4, 6, 6, 8) * 1.5 + 0.3).to(dtype)
    shape = (4, 6, 3, 4) if resample == "pool" else (4, 6, 12, 16)
    dy = torch.randn(shape).to(dtype)
    results = []
    for m, fused in ((module, True), (before, False)):
        xr = x.clone().requires_grad_(True)
        start = counted()
        y = m(xr, 2, LEAKY_SLOPE, resample) if fused else STOCK[resample](m(xr, 2, LEAKY_SLOPE))
        counts = delta(start)
        grads = torch.autograd.grad(y, (xr, m.weight, m.bias), dy)
        results.append((y, *grads, m.running_mean, m.running_var, counts))
    for a, r in zip(results[0][:-1], results[1][:-1]):
        assert a.dtype == r.dtype and torch.equal(a, r)
    taken = mode == "kernels"
    assert results[0][-1] == {"resample_pool": taken and resample == "pool",
                              "resample_up": taken and resample == "up",
                              "pool_stock": not taken and resample == "pool",
                              "up_stock": not taken and resample == "up"}


def test_an_odd_plane_takes_the_stock_pool_on_the_kernels_route(kernels_route):
    """A pool of an odd H or W runs after the call as the stock pass (the
    floor of the plane, as ``avg_pool2d``), counted in ``pool_stock``; an
    upsample of the same plane is taken."""
    module = GroupedBatchNorm(3).train()
    x = torch.randn(4, 3, 5, 6)
    start = counted()
    y = module(x, 2, LEAKY_SLOPE, "pool")
    assert tuple(y.shape) == (4, 3, 2, 3)
    assert delta(start) == {"resample_pool": 0, "resample_up": 0, "pool_stock": 1, "up_stock": 0}
    start = counted()
    assert tuple(module(x, 2, LEAKY_SLOPE, "up").shape) == (4, 3, 10, 12)
    assert delta(start) == {"resample_pool": 0, "resample_up": 1, "pool_stock": 0, "up_stock": 0}


# ---------------------------------------------------------------------------
# the encoder and decoder against the wiring before the change
# ---------------------------------------------------------------------------

def _run_before(block, y, groups, checkpointed):
    if checkpointed and torch.is_grad_enabled():
        return remat(block, block, y, groups)
    return block(y, groups)


def encoder_before(enc: Encoder, x: torch.Tensor, groups: int):
    """``Encoder.forward`` as it was: the stock pool after the stem's
    BatchNorm and after each stage's block."""
    y = avg_pool2(enc.main["1"](enc.main["0"](x), groups, LEAKY_SLOPE))
    for name in enc.stages[:-1]:
        y = avg_pool2(_run_before(enc.main[name], y, groups, enc.remat))
    y = _run_before(enc.main[enc.stages[-1]], y, groups, enc.remat)
    return enc.fc(y.flatten(1)).float().chunk(2, dim=1)


def decoder_before(dec: Decoder, z: torch.Tensor, groups: int):
    """``Decoder.forward`` as it was: the stock upsample after each stage's
    block."""
    h, w, _ = dec.conv_input_size
    y = dec.fc(z.reshape(z.shape[0], -1)).reshape(z.shape[0], -1, h, w)
    for name in dec.stages[:-1]:
        y = upsample_nearest2(_run_before(dec.main[name], y, groups, dec.remat))
    y = _run_before(dec.main[dec.stages[-1]], y, groups, dec.remat)
    return torch.sigmoid(dec.main["predict"](y).float())


def _pass(net, fn, inp, groups, whole_pass):
    """fn(inp, groups), the whole pass recomputed in the backward under
    remat "pass" (``solvers/intro.py``)."""
    if whole_pass:
        return remat(net, fn, inp, groups)
    return fn(inp, groups)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("remat_mode", [False, "block", "pass"])
@pytest.mark.parametrize("arch", ["conv", "res", "inception"])
def test_models_are_the_wiring_before(request, arch, remat_mode, groups, route):
    """Encoder and decoder forward and backward against the oracles above
    on copies of the same modules: mu, logvar, the image, the gradients of
    the input and of every parameter, and the running statistics, bit for
    bit."""
    if route == "kernels":
        request.getfixturevalue("kernels_route")
    torch.manual_seed(1)
    kw = dict(arch=arch, cdim=3, zdim=6, channels=(4, 8), image_size=16,
              remat=remat_mode == "block")
    enc, dec = Encoder(**kw).train(), Decoder(**kw).train()
    enc0, dec0 = copy.deepcopy(enc), copy.deepcopy(dec)
    x = torch.rand(4, 3, 16, 16)
    z = torch.randn(4, 6)
    whole_pass = remat_mode == "pass"
    sides = []
    for e, d, fe, fd in ((enc, dec, enc, dec),
                         (enc0, dec0, lambda t, g: encoder_before(enc0, t, g),
                          lambda t, g: decoder_before(dec0, t, g))):
        xr, zr = x.clone().requires_grad_(True), z.clone().requires_grad_(True)
        mu, logvar = _pass(e, fe, xr, groups, whole_pass)
        img = _pass(d, fd, zr, groups, whole_pass)
        loss = (mu * 1.3).sum() + (logvar * 0.7).sum() + (img * img).sum()
        params = [*e.parameters(), *d.parameters()]
        grads = torch.autograd.grad(loss, [xr, zr, *params])
        sides.append(([mu, logvar, img, *grads], [*e.buffers(), *d.buffers()]))
    for got, want in zip(sides[0][0] + sides[0][1], sides[1][0] + sides[1][1]):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# a step's counts in each train cell's model
# ---------------------------------------------------------------------------

# The three train cells' models (arch, image size, stages), their widths cut
# to 4-8 channels and z to 8; a stage count and the planes are the cell's
CELLS = {"itc64.train": ("conv", 64, (8, 8, 8, 8)),
         "itc128.train": ("conv", 128, (8, 8, 8, 8, 8)),
         "itc256res.train": ("res", 256, (4, 4, 4, 4, 4, 4))}
# (resample_pool, resample_up, pool_stock, up_stock) a paired intro step:
# three encoder calls (the batch; rec and fake in phase E, again in phase
# D) and four decoder calls
TABLE = {"itc64.train": (12, 16, 0, 0), "itc128.train": (15, 20, 0, 0),
         "itc256res.train": (3, 0, 15, 24)}


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_step_counts_its_resamples(kernels_route, cell):
    arch, size, channels = CELLS[cell]
    solver, state, x = bench.build_solver("intro_tc", 2, size, "cpu", arch=arch, zdim=8,
                                          channels=channels, fuse_passes=True, **bench.BETAS)
    start = counted()
    solver.train_step(state, x)
    assert delta(start) == dict(zip(KEYS, TABLE[cell]))


@pytest.mark.parametrize("cell", list(CELLS))
def test_on_the_cpu_every_resample_is_a_stock_pass(cell):
    """The same step on the plain route: no resample taken, each one a
    stock pass."""
    arch, size, channels = CELLS[cell]
    solver, state, x = bench.build_solver("intro_tc", 2, size, "cpu", arch=arch, zdim=8,
                                          channels=channels, fuse_passes=True, **bench.BETAS)
    start = counted()
    solver.train_step(state, x)
    pools, ups, pool_stock, up_stock = TABLE[cell]
    assert delta(start) == {"resample_pool": 0, "resample_up": 0,
                            "pool_stock": pools + pool_stock, "up_stock": ups + up_stock}


# ---------------------------------------------------------------------------
# the benchmark's reader
# ---------------------------------------------------------------------------

def test_the_reader_reads_the_resamples_a_step(monkeypatch):
    from perfbench.core import spec

    from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep
    from intro_tc_vae_tpu_torch.utils import tracing

    read = spec.metric_reader("fused_resample_calls.train")
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=64, phase_capacity=8))
    saved = dict(bc.RESAMPLES)
    try:
        bc.RESAMPLES.update(resample_pool=0, resample_up=0)
        assert read(None) is None  # no graphed step
        graphed = GraphedStep(lambda *a: {}, (), 1)
        graphed.eager, graphed.replays = 3, 5
        assert read(None) is None  # neither counter in the launches, as on the parent
        bc.RESAMPLES.update(resample_pool=96, resample_up=128)
        assert read(None) == pytest.approx(28.0)
        bc.RESAMPLES.update(resample_pool=24, resample_up=0)
        assert read(None) == pytest.approx(3.0)
    finally:
        bc.RESAMPLES.update(saved)


# ---------------------------------------------------------------------------
# the channels-last bodies on the card
# ---------------------------------------------------------------------------

# x's planes and channels of the three train cells' resampled calls: the
# stem's and each stage's pool, each stage's upsample
NHWC_RESAMPLED = [(64, 128, "pool"), (32, 64, "pool"), (256, 8, "pool"), (512, 8, "pool"),
                  (512, 4, "up"), (256, 16, "up"), (128, 32, "up"), (64, 64, "up"),
                  (64, 128, "up")]
ROUNDING = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11, torch.float32: 0.5e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BatchNorm kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("c,side,resample", NHWC_RESAMPLED)
def test_nhwc_resampled_calls_match_float64(dev, c, side, resample, dtype):
    """A channels-last call whose resample the NHWC bodies take, against
    float64 on the same inputs: y against the plain version and the stock
    pass, within three roundings of the dtype (the call's two and the
    pool's) of the resampled |y| (a window's terms may cancel); dx, dweight
    and dbias against the kernels' form of the gradient
    (``batchnorm_act_backward_reference``) of the resample's float64
    backward, rounded to the dtype where the kernels store it (an
    upsample's summed gradient), at the plain kernels' tolerances."""
    g = torch.Generator().manual_seed(side + c)
    n, groups = 8, 2
    x = (torch.randn(n, c, side, side, generator=g) * 1.7 + 0.3).to(dtype)
    w = torch.rand(c, generator=g) * 0.4 + 0.8
    b = torch.rand(c, generator=g) * 0.2 - 0.1
    dy = torch.randn(bc.resampled_shape(x, resample), generator=g).to(dtype)
    xc = x.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    wc, bcu = w.to(dev).requires_grad_(True), b.to(dev).requires_grad_(True)
    y = bc._BatchNormAct.apply(xc, wc, bcu, None, groups, 1e-4, 0.1, 0.2, resample)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y.backward(dy.to(dev).contiguous(memory_format=torch.channels_last))
    f64 = torch.float64
    xr, wr, br = x.to(f64), w.to(f64), b.to(f64)
    full = bn.batchnorm_act(xr, wr, br, None, groups, 1e-4, 0.1, 0.2, f64)
    yr, scale = STOCK[resample](full), STOCK[resample](full.abs())
    flat = torch.zeros(x.shape, dtype=f64, requires_grad=True)
    (dflat,) = torch.autograd.grad(STOCK[resample](flat), flat, dy.to(f64))
    if resample == "up":
        dflat = dflat.to(dtype).to(f64)
    want = bn.batchnorm_act_backward_reference(xr, dflat, wr, br, groups, 1e-4, 0.2)
    e = ROUNDING[dtype]
    for name, got, ref, size, tol in (("y", y, yr, scale, 3 * e),
                                      ("dx", xc.grad, want[0], want[0].abs(), e)):
        got = got.detach().cpu().double()
        m = float(ref.abs().max())
        assert bool(((got - ref).abs() <= tol * size + 1e-4 * m).all()), name
    for name, got, ref in (("dweight", wc.grad, want[1]), ("dbias", bcu.grad, want[2])):
        got = got.cpu().double()
        m = float(ref.abs().max())
        assert bool(((got - ref).abs() <= 1e-3 * (ref.abs() + m)).all()), name
