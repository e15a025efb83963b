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
the running statistics rtol 1e-5.
"""

import pytest
import torch

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


def test_every_kernel_name_counts_as_memory_bound(dev):
    """The benchmark's ``memory_bound_ms.train`` reads the kernels by their
    names on the card: every ``bn_`` kernel counts there, and none as a
    hand conv or TC kernel or a library product."""
    from perfbench.core.trace import is_hand, is_library_compute, is_memory_bound

    x, w, b, dy = inputs((16, 64, 8, 8), torch.bfloat16, dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kernels(x, w, b, dy, 2, 0.2)
        torch.cuda.synchronize(dev)
    names = {e.name for e in prof.events() if "bn_" in e.name}
    for k in bc.KERNELS:
        assert any(k in n for n in names), (k, names)
    for n in names:
        assert is_memory_bound(n) and not is_hand(n) and not is_library_compute(n), n
