"""The train-mode BatchNorm + leaky ReLU kernels on the card (marker
``cuda``; ``intro_tc_vae_tpu_torch/csrc/bn_kernels.cu``,
``ops/batchnorm_cuda.py``). They need a CUDA device and ``nvcc`` and skip
without one; the file imports no jax, so on the machine with the card run

    python -m pytest --noconftest -m cuda tests/test_torch_bn_cuda.py

Against the plain version evaluated in float64 on the same (rounded)
inputs (``ops/batchnorm.py``), with M the largest |reference| of the
tensor: y and dx |d| <= e |ref| + 1e-4 M, e the dtype's two roundings of y
(bf16 2^-7, fp16 2^-10; fp32 1e-5) and one of dx; dweight and dbias
(sums of up to 2.1 M fp32 terms in a fixed tree) |d| <= 1e-3 (|ref| + M);
the running statistics rtol 1e-5. The resample variants (a 2x2 average
pool or a nearest 2x upsample taken into the call) against the kernels
followed by the stock pass and its autograd: bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.models.blocks import GroupedBatchNorm
from intro_tc_vae_tpu_torch.ops import batchnorm as bn
from intro_tc_vae_tpu_torch.ops import batchnorm_cuda as bc
from intro_tc_vae_tpu_torch.ops import launch_counts

pytestmark = pytest.mark.cuda
EPS, MOMENTUM = 1e-4, 0.1
ROUNDING = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11, torch.float32: 0.5e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BatchNorm kernels have no CPU build")
    return torch.device("cuda", 0)


def inputs(shape, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 1.7 + 0.3).to(dtype).to(dev)
    w = (torch.rand(c, generator=g) * 0.4 + 0.8).to(dev)
    b = (torch.rand(c, generator=g) * 0.2 - 0.1).to(dev)
    dy = torch.randn(shape, generator=g).to(dtype).to(dev)
    return x, w, b, dy


def kernels(x, w, b, dy, groups, slope, running=True, grads=(True, True, True)):
    """y, dx, dweight, dbias, running mean and var through the kernels."""
    c = x.shape[1]
    rm, rv = torch.zeros(c, device=x.device), torch.ones(c, device=x.device)
    xr = x.clone().requires_grad_(grads[0])
    wr, br = w.clone().requires_grad_(grads[1]), b.clone().requires_grad_(grads[2])
    y = bc._BatchNormAct.apply(xr, wr, br, (rm, rv) if running else None, groups, EPS,
                               MOMENTUM, slope)
    y.backward(dy)
    return y.detach(), xr.grad, wr.grad, br.grad, rm, rv


def reference(x, w, b, dy, groups, slope):
    c, f64 = x.shape[1], torch.float64
    rm, rv = torch.zeros(c, device=x.device, dtype=f64), torch.ones(c, device=x.device, dtype=f64)
    y = bn.batchnorm_act(x.double(), w.double(), b.double(), (rm, rv), groups, EPS, MOMENTUM,
                         slope, f64)
    dx, dw, db = bn.batchnorm_act_backward_reference(x.double(), dy.double(), w.double(),
                                                     b.double(), groups, EPS, slope)
    return y, dx, dw, db, rm, rv


def close(name, got, want, e):
    m = float(want.abs().max())
    d = (got.double() - want).abs()
    if name in ("y", "dx"):
        ok = d <= e * want.abs() + 1e-4 * m
    elif name in ("dweight", "dbias"):
        ok = d <= 1e-3 * (want.abs() + m)
    else:
        ok = d <= 1e-5 * want.abs()
    assert bool(ok.all()), f"{name}: max |d| {float(d.max()):.3g}, max |ref| {m:.3g}"


CASES = [  # shape, groups, dtype, slope: the flagship's largest and smallest calls,
    # the 128 px step's largest, fp32 and fp16, and planes of no whole vector
    ((128, 64, 64, 64), 2, torch.bfloat16, 0.2),
    ((64, 64, 64, 64), 1, torch.bfloat16, 0.2),
    ((128, 64, 64, 64), 2, torch.bfloat16, 1.0),
    ((128, 128, 32, 32), 2, torch.bfloat16, 0.2),
    ((128, 512, 4, 4), 2, torch.bfloat16, 0.2),
    ((64, 512, 4, 4), 1, torch.bfloat16, 0.2),
    ((256, 64, 128, 128), 2, torch.bfloat16, 0.2),
    ((128, 64, 64, 64), 2, torch.float32, 0.2),
    ((128, 512, 4, 4), 2, torch.float32, 0.2),
    ((64, 256, 8, 8), 1, torch.float16, 0.2),
    ((6, 10, 5, 3), 2, torch.bfloat16, 0.2),
    ((12, 24, 6, 6), 3, torch.float32, 1.0),
]


@pytest.mark.parametrize("shape,groups,dtype,slope", CASES)
def test_kernels_match_the_plain_version(dev, shape, groups, dtype, slope):
    x, w, b, dy = inputs(shape, dtype, dev)
    got = kernels(x, w, b, dy, groups, slope)
    want = reference(x, w, b, dy, groups, slope)
    e = ROUNDING[dtype]
    for name, a, r in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        assert a.dtype == (dtype if name in ("y", "dx") else torch.float32), name
        close(name, a, r, (2 if name == "y" and slope != 1.0 else 1) * e)


def test_two_runs_are_bitwise_equal(dev):
    """No atomics: every output has the same bits in two runs."""
    x, w, b, dy = inputs((128, 64, 64, 64), torch.bfloat16, dev, seed=1)
    first = kernels(x, w, b, dy, 2, 0.2)
    second = kernels(x, w, b, dy, 2, 0.2)
    for a, r in zip(first, second):
        assert torch.equal(a, r)


def test_only_the_gradients_asked_for_are_computed(dev):
    """Frozen weight and bias: no parameter gradient, the same dx; no
    running statistics (a remat recompute): the buffers stay."""
    x, w, b, dy = inputs((64, 128, 16, 16), torch.bfloat16, dev, seed=2)
    full = kernels(x, w, b, dy, 2, 0.2)
    frozen = kernels(x, w, b, dy, 2, 0.2, running=False, grads=(True, False, False))
    assert frozen[2] is None and frozen[3] is None
    assert torch.equal(frozen[0], full[0]) and torch.equal(frozen[1], full[1])
    assert torch.equal(frozen[4], torch.zeros_like(frozen[4]))
    assert torch.equal(frozen[5], torch.ones_like(frozen[5]))
    params_only = kernels(x, w, b, dy, 2, 0.2, grads=(False, True, True))
    assert params_only[1] is None
    assert torch.equal(params_only[2], full[2]) and torch.equal(params_only[3], full[3])


def test_a_captured_graph_counts_the_launches(dev):
    """The module's forward and backward captured: the tally holds the five
    kernels once each, and each replay adds them; no call is counted on
    the plain route."""
    module = GroupedBatchNorm(64, eps=EPS, compute_dtype=torch.bfloat16).to(dev).train()
    x = torch.randn(32, 64, 16, 16, device=dev).to(torch.bfloat16).requires_grad_(True)

    def body():
        y = module(x, 2, 0.2)
        return torch.autograd.grad(y.float().square().sum(), (x, module.weight, module.bias))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()  # warm-up, outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_counts.recording() as tally, torch.cuda.graph(graph):
        body()
    assert tally.launches() == {"bn_stats": 1, "bn_finalize": 1, "bn_apply": 1,
                                "bn_bwd_reduce": 1, "bn_bwd_dx": 1}
    before_l, before_c = dict(bc.LAUNCHES), dict(bc.CALLS)
    for _ in range(3):
        graph.replay()
        tally.add()
    torch.cuda.synchronize(dev)
    assert {k: bc.LAUNCHES[k] - before_l[k] for k in bc.KERNELS} == dict.fromkeys(bc.KERNELS, 3)
    assert bc.CALLS == before_c


def test_the_module_routes_by_what_it_observes(dev):
    """bf16 and fp32 train-mode calls take the kernels; a float64 one, or
    one whose output dtype is not x's, is refused, not sent elsewhere;
    eval mode launches no kernel."""
    before_l, before_c = dict(bc.LAUNCHES), dict(bc.CALLS)
    for dtype in (torch.bfloat16, torch.float32):
        module = GroupedBatchNorm(8, compute_dtype=dtype).to(dev).train()
        module(torch.randn(4, 8, 4, 4, device=dev).to(dtype), 2, 0.2)
    assert bc.LAUNCHES["bn_stats"] - before_l["bn_stats"] == 2
    module64 = GroupedBatchNorm(8, compute_dtype=torch.float64).to(dev).double().train()
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        module64(torch.randn(4, 8, 4, 4, device=dev, dtype=torch.float64), 2, 0.2)
    mixed = GroupedBatchNorm(8, compute_dtype=torch.bfloat16).to(dev).train()
    with pytest.raises(ValueError, match="x's dtype"):
        mixed(torch.randn(4, 8, 4, 4, device=dev), 2, 0.2)
    assert bc.CALLS == before_c
    launched = dict(bc.LAUNCHES)
    module.eval()
    module(torch.randn(4, 8, 4, 4, device=dev), 1, 0.2)
    assert bc.LAUNCHES == launched
    assert {k: bc.LAUNCHES[k] - before_l[k] for k in ("bn_stats", "bn_apply")} == \
        {"bn_stats": 2, "bn_apply": 2}


RESAMPLED_KERNELS = ("bn_apply_pool", "bn_apply_up", "bn_bwd_reduce_pool", "bn_bwd_reduce_up",
                     "bn_bwd_dx_pool")


def test_every_kernel_name_counts_as_memory_bound(dev):
    """The benchmark's ``memory_bound_ms.train`` reads the kernels by their
    names on the card: every ``bn_`` kernel, the resample variants' too,
    counts there, and none as a hand conv or TC kernel or a library
    product."""
    from perfbench.core.trace import is_hand, is_library_compute, is_memory_bound

    x, w, b, dy = inputs((16, 64, 8, 8), torch.bfloat16, dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kernels(x, w, b, dy, 2, 0.2)
        for resample in ("pool", "up"):
            resampled(x, w, b, grad_of(x, resample), 2, 0.2, resample, fused=True)
        torch.cuda.synchronize(dev)
    names = {e.name for e in prof.events() if "bn_" in e.name}
    for k in bc.KERNELS + RESAMPLED_KERNELS:
        assert any(k in n for n in names), (k, names)
    for n in names:
        assert is_memory_bound(n) and not is_hand(n) and not is_library_compute(n), n


# ---------------------------------------------------------------------------
# the resample variants
# ---------------------------------------------------------------------------

STOCK = {"pool": lambda t: F.avg_pool2d(t, 2),
         "up": lambda t: F.interpolate(t, scale_factor=2, mode="nearest")}


def grad_of(x, resample, seed=3, offset=0):
    """A gradient for x's resampled output; ``offset`` elements into its
    storage (a misaligned tensor, which the kernels read element by
    element)."""
    n, c, h, w = x.shape
    shape = (n, c, h // 2, w // 2) if resample == "pool" else (n, c, 2 * h, 2 * w)
    numel = n * c * shape[2] * shape[3]
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(numel + offset, generator=g).to(x.dtype).to(x.device)
    return flat[offset:].view(shape)


def misaligned_copy(x):
    """x's values one element into a fresh storage: 16-byte vectors refused."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


def resampled(x, w, b, dy, groups, slope, resample, fused, running=True, misaligned=False):
    """y, dx, dweight, dbias, running mean and var of a call whose resample
    the kernels take (``fused``), or of the kernels and the stock pass; x
    misaligned to 16 bytes if asked."""
    c = x.shape[1]
    rm, rv = torch.zeros(c, device=x.device), torch.ones(c, device=x.device)
    xr = (misaligned_copy(x) if misaligned else x.clone()).requires_grad_(True)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    stats = (rm, rv) if running else None
    if fused:
        y = bc._BatchNormAct.apply(xr, wr, br, stats, groups, EPS, MOMENTUM, slope, resample)
    else:
        y = STOCK[resample](bc._BatchNormAct.apply(xr, wr, br, stats, groups, EPS, MOMENTUM,
                                                   slope))
    y.backward(dy)
    return y.detach(), xr.grad, wr.grad, br.grad, rm, rv


def assert_bitwise(got, want, what):
    for name, a, r in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        assert a.shape == r.shape and a.dtype == r.dtype, (what, name)
        assert torch.equal(a, r), (what, name, float((a.double() - r.double()).abs().max()))


# the planes the three train cells resample: pools from 128^2 down to 8^2,
# upsamples from 4^2 up to 64^2; 12 samples, so 1, 2 and 3 groups divide them
POOLED = [128, 64, 32, 16, 8]
UPSAMPLED = [4, 8, 16, 32, 64]


@pytest.mark.parametrize("slope", [0.2, 1.0])
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_resample_variants_are_the_kernels_and_the_stock_pass(dev, dtype, groups, slope):
    for resample, planes in (("pool", POOLED), ("up", UPSAMPLED)):
        for side in planes:
            c = 8 if side >= 64 else 32
            x, w, b, _ = inputs((12, c, side, side), dtype, dev, seed=side)
            dy = grad_of(x, resample)
            got = resampled(x, w, b, dy, groups, slope, resample, fused=True)
            want = resampled(x, w, b, dy, groups, slope, resample, fused=False)
            assert_bitwise(got, want, (resample, side))


@pytest.mark.parametrize("resample", ["pool", "up"])
def test_one_element_a_vector_and_a_misaligned_gradient(dev, resample):
    """x misaligned to 16 bytes (a plan of vector width 1), a gradient
    misaligned (read element by element in x's plan), planes whose rows
    hold no whole vector (W 4 and 12 in bf16; W 6): the same bits."""
    for shape, dtype in (((12, 16, 16, 16), torch.bfloat16), ((12, 16, 4, 4), torch.bfloat16),
                         ((6, 8, 8, 12), torch.bfloat16), ((6, 8, 6, 6), torch.float32)):
        x, w, b, _ = inputs(shape, dtype, dev, seed=7)
        assert bc.plan_of(misaligned_copy(x), 2)[0].vector == 1
        for misaligned in (False, True):
            for offset in (0, 1):
                dy = grad_of(x, resample, offset=offset)
                got = resampled(x, w, b, dy, 2, 0.2, resample, True, misaligned=misaligned)
                want = resampled(x, w, b, dy, 2, 0.2, resample, False, misaligned=misaligned)
                assert_bitwise(got, want, (shape, misaligned, offset))


def test_frozen_parameters_and_a_recompute_with_a_resample(dev):
    """Only the gradients asked for, and no running statistics, as the
    plain kernels; the rest as with all of them."""
    x, w, b, _ = inputs((12, 32, 16, 16), torch.bfloat16, dev, seed=4)
    for resample in ("pool", "up"):
        dy = grad_of(x, resample)
        full = resampled(x, w, b, dy, 2, 0.2, resample, fused=True)
        frozen = resampled(x, w, b, dy, 2, 0.2, resample, fused=True, running=False)
        assert torch.equal(frozen[0], full[0]) and torch.equal(frozen[1], full[1])
        assert torch.equal(frozen[4], torch.zeros_like(frozen[4]))
        xr = x.clone().requires_grad_(True)
        y = bc._BatchNormAct.apply(xr, w, b, None, 2, EPS, MOMENTUM, 0.2, resample)
        (dx,) = torch.autograd.grad(y, (xr,), dy)
        assert torch.equal(y, full[0]) and torch.equal(dx, full[1])


def test_an_odd_plane_takes_the_stock_pool_and_is_counted(dev):
    """A pool of an odd H or W runs as the stock pass after the kernels
    (``pool_stock``); an upsample of any plane is taken (``resample_up``)."""
    module = GroupedBatchNorm(8, eps=EPS, compute_dtype=torch.bfloat16).to(dev).train()
    for shape in ((4, 8, 5, 6), (4, 8, 6, 5)):
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        before = dict(bc.RESAMPLES)
        got = module(x, 2, 0.2, "pool")
        assert bc.RESAMPLES == {**before, "pool_stock": before["pool_stock"] + 1}
        assert torch.equal(got, F.avg_pool2d(module(x, 2, 0.2), 2))
        before = dict(bc.RESAMPLES)
        got = module(x, 2, 0.2, "up")
        assert bc.RESAMPLES == {**before, "resample_up": before["resample_up"] + 1}
        assert torch.equal(got, STOCK["up"](module(x, 2, 0.2)))


def test_a_captured_graph_keeps_the_resample_counts(dev):
    """A module's pooled and upsampled calls, forward and backward,
    captured: the tally holds the five kernels twice and one resample of
    each kind, and each replay adds them, as the launches."""
    module = GroupedBatchNorm(64, eps=EPS, compute_dtype=torch.bfloat16).to(dev).train()
    x = torch.randn(32, 64, 16, 16, device=dev).to(torch.bfloat16).requires_grad_(True)

    def body():
        y = module(x, 2, 0.2, "pool").float().square().sum() + \
            module(x, 2, 0.2, "up").float().square().sum()
        return torch.autograd.grad(y, (x, module.weight, module.bias))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()  # warm-up, outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_counts.recording() as tally, torch.cuda.graph(graph):
        body()
    assert tally.launches() == {**dict.fromkeys(bc.KERNELS, 2), "resample_pool": 1,
                                "resample_up": 1}
    before = {**bc.LAUNCHES, **bc.RESAMPLES}
    for _ in range(3):
        graph.replay()
        tally.add()
    torch.cuda.synchronize(dev)
    after = {**bc.LAUNCHES, **bc.RESAMPLES}
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(bc.KERNELS, 6),
                                                         "resample_pool": 3, "resample_up": 3,
                                                         "pool_stock": 0, "up_stock": 0}


# ---------------------------------------------------------------------------
# the channels-last (NHWC) bodies
# ---------------------------------------------------------------------------

CL = torch.channels_last


def nhwc_kernels(x, w, b, dy, groups, slope, running=True, grads=(True, True, True),
                 resample=None):
    """``kernels`` on x and dy laid channels-last: y, dx, dweight, dbias and
    the running statistics; y and dx must come back channels-last."""
    c = x.shape[1]
    rm, rv = torch.zeros(c, device=x.device), torch.ones(c, device=x.device)
    xr = x.contiguous(memory_format=CL).requires_grad_(grads[0])
    assert bc.nhwc(xr)
    wr, br = w.clone().requires_grad_(grads[1]), b.clone().requires_grad_(grads[2])
    y = bc._BatchNormAct.apply(xr, wr, br, (rm, rv) if running else None, groups, EPS,
                               MOMENTUM, slope, resample)
    y.backward(dy.contiguous(memory_format=CL))
    if min(y.shape[1], y.shape[2] * y.shape[3]) > 1:
        assert y.is_contiguous(memory_format=CL) and not y.is_contiguous()
    if xr.grad is not None and min(c, x.shape[2] * x.shape[3]) > 1:
        assert xr.grad.is_contiguous(memory_format=CL)
    return y.detach(), xr.grad, wr.grad, br.grad, rm, rv


NHWC_CASES = [  # the three train cells' channels-last calls (after a stock conv), fp32,
    # fp16, and channels of no whole vector (one channel a thread)
    ((128, 512, 4, 4), 2, torch.bfloat16, 0.2), ((64, 512, 4, 4), 1, torch.bfloat16, 0.2),
    ((128, 256, 16, 16), 2, torch.bfloat16, 0.2), ((128, 128, 32, 32), 2, torch.bfloat16, 0.2),
    ((128, 64, 64, 64), 2, torch.bfloat16, 0.2), ((256, 128, 64, 64), 2, torch.bfloat16, 0.2),
    ((64, 64, 256, 256), 2, torch.bfloat16, 0.2), ((64, 64, 128, 128), 2, torch.bfloat16, 1.0),
    ((128, 512, 8, 8), 2, torch.float32, 0.2), ((64, 256, 8, 8), 1, torch.float16, 0.2),
    ((6, 10, 5, 3), 2, torch.bfloat16, 0.2), ((12, 24, 6, 6), 3, torch.float32, 1.0),
]


@pytest.mark.parametrize("shape,groups,dtype,slope", NHWC_CASES)
def test_nhwc_bodies_match_the_plain_version(dev, shape, groups, dtype, slope):
    """The NHWC bodies against the float64 plain version, at the plain
    kernels' tolerances; the outputs in x's layout."""
    x, w, b, dy = inputs(shape, dtype, dev)
    got = nhwc_kernels(x, w, b, dy, groups, slope)
    want = reference(x, w, b, dy, groups, slope)
    e = ROUNDING[dtype]
    for name, a, r in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        close(name, a, r, (2 if name == "y" and slope != 1.0 else 1) * e)


@pytest.mark.parametrize("resample", [None, "pool", "up"])
def test_nhwc_reruns_are_bitwise_equal(dev, resample):
    """No atomics in the NHWC bodies either: every output has the same bits
    in two runs."""
    x, w, b, _ = inputs((128, 64, 32, 32), torch.bfloat16, dev, seed=1)
    dy = grad_of(x, resample) if resample else inputs(x.shape, torch.bfloat16, dev, 5)[3]
    first = nhwc_kernels(x, w, b, dy, 2, 0.2, resample=resample)
    second = nhwc_kernels(x, w, b, dy, 2, 0.2, resample=resample)
    for a, r in zip(first, second):
        assert torch.equal(a, r)


@pytest.mark.parametrize("shape,groups,dtype", [((128, 64, 64, 64), 2, torch.bfloat16),
                                                 ((128, 512, 4, 4), 2, torch.bfloat16),
                                                 ((64, 256, 8, 8), 1, torch.float16),
                                                 ((32, 128, 16, 16), 2, torch.float32)])
def test_nhwc_and_nchw_agree_within_one_rounding(dev, shape, groups, dtype):
    """The same call in both layouts: the statistics are sums of the same
    terms in another order, so y and dx lie within one rounding of the
    dtype of each other, dweight and dbias within fp32 sums' order."""
    x, w, b, dy = inputs(shape, dtype, dev, seed=3)
    a = nhwc_kernels(x, w, b, dy, groups, 0.2)
    r = kernels(x, w, b, dy, groups, 0.2)
    ulp = 2 * ROUNDING[dtype]
    for name, p, q in zip(("y", "dx"), a[:2], r[:2]):
        d = (p.double() - q.double()).abs()
        m = float(q.abs().max())
        assert bool((d <= ulp * q.double().abs() + 1e-4 * m).all()), (name, float(d.max()))
    for name, p, q in zip(("dweight", "dbias", "running_mean", "running_var"), a[2:], r[2:]):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-4 * float(q.abs().max()),
                                   msg=name)


def test_nhwc_computes_only_the_gradients_asked_for(dev):
    """Frozen weight and bias: no parameter gradient, the same dx; no
    running statistics: the buffers stay; no dx: the same dweight, dbias."""
    x, w, b, dy = inputs((64, 128, 16, 16), torch.bfloat16, dev, seed=2)
    full = nhwc_kernels(x, w, b, dy, 2, 0.2)
    frozen = nhwc_kernels(x, w, b, dy, 2, 0.2, running=False, grads=(True, False, False))
    assert frozen[2] is None and frozen[3] is None
    assert torch.equal(frozen[0], full[0]) and torch.equal(frozen[1], full[1])
    assert torch.equal(frozen[4], torch.zeros_like(frozen[4]))
    assert torch.equal(frozen[5], torch.ones_like(frozen[5]))
    params_only = nhwc_kernels(x, w, b, dy, 2, 0.2, grads=(False, True, True))
    assert params_only[1] is None
    assert torch.equal(params_only[2], full[2]) and torch.equal(params_only[3], full[3])


def test_a_captured_graph_counts_the_nhwc_calls(dev):
    """A module's call on a channels-last x, forward and backward, captured:
    the tally holds the five kernels once and ``bn_nhwc`` once, and each
    replay adds them."""
    module = GroupedBatchNorm(64, eps=EPS, compute_dtype=torch.bfloat16).to(dev).train()
    x = torch.randn(32, 64, 16, 16, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=CL).requires_grad_(True)

    def body():
        y = module(x, 2, 0.2, "pool")
        return torch.autograd.grad(y.float().square().sum(), (x, module.weight, module.bias))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()  # warm-up, outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_counts.recording() as tally, torch.cuda.graph(graph):
        body()
    assert tally.launches() == {**dict.fromkeys(bc.KERNELS, 1), "bn_nhwc": 1,
                                "resample_pool": 1}
    before = dict(bc.CALLS)
    for _ in range(3):
        graph.replay()
        tally.add()
    torch.cuda.synchronize(dev)
    assert bc.CALLS == {**before, "bn_nhwc": before["bn_nhwc"] + 3}


def test_a_module_on_a_channels_last_x_takes_the_nhwc_bodies(dev):
    """The route by layout: a channels-last x takes the NHWC bodies and is
    counted; a contiguous one, one of one channel or of 1x1 planes (both
    layouts at once), and a misaligned one of more channel vectors than a
    block holds take the NCHW bodies."""
    module = GroupedBatchNorm(8, compute_dtype=torch.bfloat16).to(dev).train()
    for x, taken in ((torch.randn(4, 8, 6, 6, device=dev), False),
                     (torch.randn(4, 8, 6, 6, device=dev).contiguous(memory_format=CL), True),
                     (torch.randn(4, 8, 1, 1, device=dev).contiguous(memory_format=CL), False)):
        before = bc.CALLS["bn_nhwc"]
        module(x.to(torch.bfloat16), 2, 0.2)
        assert bc.CALLS["bn_nhwc"] - before == taken
    flat = torch.empty(4 * 512 * 4 * 4 + 1, device=dev, dtype=torch.bfloat16)
    odd = flat[1:].view(4, 4, 4, 512).permute(0, 3, 1, 2)
    assert odd.is_contiguous(memory_format=CL) and not bc.nhwc(odd)


def assert_reordered(got, want, dtype, what):
    """y and the running statistics bit for bit; dx within one rounding of
    the dtype, dweight and dbias within float32 sums of the same terms in
    another order."""
    for name, i in (("y", 0), ("running_mean", 4), ("running_var", 5)):
        assert got[i].shape == want[i].shape and torch.equal(got[i], want[i]), (what, name)
    d = (got[1].double() - want[1].double()).abs()
    m = float(want[1].abs().max())
    assert bool((d <= 2 * ROUNDING[dtype] * want[1].double().abs() + 1e-5 * m).all()), what
    for a, r in zip(got[2:4], want[2:4]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("slope", [0.2, 1.0])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_nhwc_resample_variants_are_the_kernels_and_the_stock_pass(dev, dtype, groups, slope):
    """Channels-last: a call whose resample the NHWC bodies take, against
    the NHWC kernels followed by the stock pass on the channels-last y, at
    the three cells' planes (pools from 128^2 down, the 4x4 and 8x8 planes
    of 512 channels, upsamples up to 128^2): an upsampled call bit for bit;
    a pooled one's y and running statistics bit for bit, its gradients
    summed window by window (``for_each_window``) in another order."""
    for resample, planes in (("pool", (128, 32, 8)), ("up", (4, 16, 64, 128))):
        for side in planes:
            c = 512 if side <= 8 else 64
            x, w, b, _ = inputs((12, c, side, side), dtype, dev, seed=side)
            dy = grad_of(x, resample).contiguous(memory_format=CL)
            xc = x.contiguous(memory_format=CL)
            got = resampled(xc, w, b, dy, groups, slope, resample, fused=True)
            want = resampled(xc, w, b, dy, groups, slope, resample, fused=False)
            if resample == "up":
                assert_bitwise(got, want, (resample, side))
            else:
                assert_reordered(got, want, dtype, (resample, side))
