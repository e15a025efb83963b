"""Train-mode GroupedBatchNorm + leaky ReLU: the plain two-pass version, the
gradient in the kernels' form and the kernels' launch plan
(``intro_tc_vae_tpu_torch/ops/batchnorm.py``), and the route a call takes
(``ops/batchnorm_cuda.py``). The kernels themselves run only on the card:
``tests/test_torch_bn_cuda.py``.

The oracle is the module as it was before the activation moved into it:
``module_before`` below repeats its train-mode arithmetic and the
``leaky_relu`` the blocks applied after it.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.models.blocks import ConvolutionalBlock, GroupedBatchNorm, remat
from intro_tc_vae_tpu_torch.ops import batchnorm as bn
from intro_tc_vae_tpu_torch.ops import batchnorm_cuda as bc

from tests._torch_threads import one_thread  # noqa: F401

F64 = torch.float64


def module_before(x, weight, bias, running, groups, eps, momentum, slope, out_dtype):
    """GroupedBatchNorm's train-mode forward before it took the activation
    (means, clamp, EMA in group order, (x - mean) * (rstd * w) + b, the cast)
    followed by the blocks' ``F.leaky_relu``."""
    b, c = x.shape[0], x.shape[1]
    bshape = (c,) + (1,) * (x.dim() - 2)
    xg = x.reshape(groups, b // groups, *x.shape[1:])
    xf = xg.to(torch.promote_types(xg.dtype, torch.float32))
    axes = (1,) + tuple(range(3, xg.dim()))
    mean = xf.mean(axes)
    var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
    if running is not None:
        keep = 1.0 - momentum
        rm, rv = running
        with torch.no_grad():
            m, v = rm.clone(), rv.clone()
            for g in range(groups):
                m = keep * m + (1.0 - keep) * mean[g].detach()
                v = keep * v + (1.0 - keep) * var[g].detach()
            rm.copy_(m)
            rv.copy_(v)
    gshape = (groups, 1) + bshape
    y = (xg - mean.reshape(gshape)) * (
        torch.rsqrt(var.reshape(gshape) + eps) * weight.reshape(bshape)
    ) + bias.reshape(bshape)
    y = y.reshape(x.shape).to(out_dtype)
    return y if slope == 1.0 else F.leaky_relu(y, slope)


def inputs(shape, dtype=F64, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, dtype=F64) * 1.5 + 0.4).to(dtype)
    w = torch.rand(c, generator=g, dtype=F64) * 0.4 + 0.8
    b = torch.rand(c, generator=g, dtype=F64) * 0.2 - 0.1
    dy = torch.randn(shape, generator=g, dtype=F64).to(dtype)
    return x, w, b, dy


def run(fn, x, w, b, dy, groups, slope, dtype, param_dtype):
    """fn's output, running statistics and autograd gradients."""
    x = x.clone().requires_grad_(True)
    w = w.to(param_dtype).requires_grad_(True)
    b = b.to(param_dtype).requires_grad_(True)
    c = x.shape[1]
    running = (torch.zeros(c, dtype=param_dtype), torch.ones(c, dtype=param_dtype))
    y = fn(x, w, b, running, groups, 1e-4, 0.1, slope, dtype)
    grads = torch.autograd.grad(y, (x, w, b), dy)
    return (y.detach(), *running, *grads)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("slope", [0.2, 1.0])
@pytest.mark.parametrize("dtype", [F64, torch.float32, torch.bfloat16])
def test_plain_version_is_the_module_before(groups, slope, dtype):
    """Values and running statistics bit for bit, gradients to rounding
    (float64: 1e-12; the others through the same operations)."""
    x, w, b, dy = inputs((4, 6, 5, 3), dtype)
    param = F64 if dtype == F64 else torch.float32
    got = run(bn.batchnorm_act, x, w, b, dy, groups, slope, dtype, param)
    want = run(module_before, x, w, b, dy, groups, slope, dtype, param)
    for i, (a, r) in enumerate(zip(got, want)):
        if i < 3:
            assert torch.equal(a, r), i
        else:
            tol = 1e-12 if dtype == F64 else 1e-5
            torch.testing.assert_close(a, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("groups,slope", [(1, 0.2), (2, 0.2), (2, 1.0), (3, 0.2), (1, 1.0)])
def test_backward_reference_is_autograd(groups, slope):
    """The kernels' form of the gradient against autograd of the module
    before, float64."""
    x, w, b, dy = inputs((6, 4, 3, 5), seed=groups)
    _, _, _, dx, dw, db = run(module_before, x, w, b, dy, groups, slope, F64, F64)
    rdx, rdw, rdb = bn.batchnorm_act_backward_reference(x, dy, w, b, groups, 1e-4, slope)
    for a, r in ((rdx, dx), (rdw, dw), (rdb, db)):
        torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-12)


def constant_channel(x, value, groups):
    """x with channel 1 of group 0 set to ``value``; that pair's variance
    before the clamp, as the module computes it."""
    x = x.clone()
    x[:x.shape[0] // groups, 1] = value
    xg = x.reshape(groups, -1, *x.shape[1:])
    mean = xg.mean((1, 3, 4))
    return x, float(((xg * xg).mean((1, 3, 4)) - mean * mean)[0, 1])


@pytest.mark.parametrize("groups", [1, 2])
def test_a_constant_channel_is_clamped_and_passes_no_gradient_through_var(groups):
    """A constant pair whose E[x^2] - E[x]^2 rounds below 0: var is
    clamped to 0, the gradient through var is zero (clamp's), and the
    kernels' form (the x-hat term dropped there) equals autograd; and one
    whose variance is exactly 0 (x - mean = 0: no term either way)."""
    x, w, b, dy = inputs((6, 3, 5, 5), seed=5)
    for value, clamped in ((0.1, True), (0.5, False)):
        xc, raw = constant_channel(x, value, groups)
        assert (raw < 0) == clamped and (clamped or raw == 0.0), raw
        y, _, rv, dx, dw, db = run(module_before, xc, w, b, dy, groups, 0.2, F64, F64)
        got = run(bn.batchnorm_act, xc, w, b, dy, groups, 0.2, F64, F64)
        assert torch.equal(got[0], y) and torch.equal(got[2], rv)
        rdx, rdw, rdb = bn.batchnorm_act_backward_reference(xc, dy, w, b, groups, 1e-4, 0.2)
        for a, r in ((rdx, dx), (rdw, dw), (rdb, db)):
            torch.testing.assert_close(a, r, rtol=1e-10, atol=1e-12)
        # the pair's dx is a (dy' - mean dy'): no x-hat term
        per = x.shape[0] // groups
        d = torch.where(y[:per, 1] > 0, dy[:per, 1], dy[:per, 1] * 0.2)
        a = w[1] / torch.sqrt(torch.tensor(1e-4, dtype=F64))
        torch.testing.assert_close(dx[:per, 1], a * (d - d.mean()), rtol=1e-9, atol=1e-12)


def test_frozen_parameters_ask_for_no_parameter_gradient():
    """Weight and bias not requiring grad: only dx is computed, and it is
    the one the kernels' form gives."""
    x, w, b, dy = inputs((4, 5, 3, 3), seed=2)
    xr = x.clone().requires_grad_(True)
    y = bn.batchnorm_act(xr, w, b, None, 2, 1e-4, 0.1, 0.2, F64)
    (dx,) = torch.autograd.grad(y, (xr,), dy)
    assert not w.requires_grad and not b.requires_grad
    torch.testing.assert_close(dx, bn.batchnorm_act_backward_reference(x, dy, w, b, 2, 1e-4,
                                                                       0.2)[0],
                               rtol=1e-10, atol=1e-12)


def test_running_statistics_take_the_group_updates_in_order():
    """groups 3: the running averages are three sequential EMA updates,
    one a group, each with that group's mean and biased variance."""
    x, w, b, _ = inputs((6, 4, 2, 2), seed=3)
    rm, rv = torch.full((4,), 0.3, dtype=F64), torch.full((4,), 2.0, dtype=F64)
    bn.batchnorm_act(x, w, b, (rm, rv), 3, 1e-4, 0.1, 0.2, F64)
    m, v = torch.full((4,), 0.3, dtype=F64), torch.full((4,), 2.0, dtype=F64)
    for g in range(3):
        xs = x[2 * g:2 * g + 2].transpose(0, 1).reshape(4, -1)
        m = 0.9 * m + 0.1 * xs.mean(1)
        v = 0.9 * v + 0.1 * xs.var(1, unbiased=False)
    torch.testing.assert_close(rm, m, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(rv, v, rtol=1e-12, atol=1e-14)


def test_remat_recompute_leaves_the_running_statistics():
    """A ConvolutionalBlock under ``remat``: the same output and gradients
    as without, and the running statistics moved by one forward only."""
    torch.manual_seed(0)
    block = ConvolutionalBlock(3, 4, compute_dtype=F64).double().train()
    x = torch.randn(4, 3, 8, 8, dtype=F64, requires_grad=True)
    plain = ConvolutionalBlock(3, 4, compute_dtype=F64).double().train()
    plain.load_state_dict(block.state_dict())
    y0 = plain(x, 2)
    g0 = torch.autograd.grad(y0.sum(), [x, *plain.parameters()])
    y1 = remat(block, block, x, 2)
    g1 = torch.autograd.grad(y1.sum(), [x, *block.parameters()])
    assert torch.equal(y0, y1)
    for a, r in zip(g1, g0):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-14)
    for name, buf in plain.named_buffers():
        assert torch.equal(dict(block.named_buffers())[name], buf), name


SHAPES = [  # (n, c, hw, groups): the flagship's and the 128 px step's calls, and ragged ones
    (128, 64, 64 * 64, 2), (64, 64, 64 * 64, 1), (128, 128, 32 * 32, 2), (64, 128, 32 * 32, 1),
    (128, 256, 16 * 16, 2), (128, 512, 8 * 8, 2), (128, 512, 4 * 4, 2), (64, 512, 4 * 4, 1),
    (128, 64, 32 * 32, 2), (256, 64, 128 * 128, 2), (128, 64, 128 * 128, 1),
    (256, 512, 8 * 8, 2), (6, 10, 15, 2), (12, 24, 36, 3), (7, 3, 5, 1), (128, 64, 48 * 48, 2),
]


def slice_samples(plan: bn.Plan, per_group: int, s: int) -> range:
    """The samples of a group (0-based within it) that run ``s`` holds."""
    first = s * plan.samples
    return range(first, min(first + plan.samples, per_group))


def thread_vectors(plane: int, count: int, threads: int, t: int) -> list:
    """The (sample, vector) pairs thread ``t`` of a block visits, in order,
    for a run of ``count`` samples of ``plane`` vectors each: vector index
    v = t, t + threads, ... of the run, stepped without a division as
    ``csrc/bn_kernels.cu::for_each_vector`` steps it. A model of the
    kernel's loop: the loop itself is held to every element on the card
    (``tests/test_torch_bn_cuda.py`` at ragged shapes)."""
    q, r = divmod(threads, plane)
    smp, o = divmod(t, plane)
    out = []
    while smp < count:
        out.append((smp, o))
        o += r
        smp += q
        if o >= plane:
            o -= plane
            smp += 1
    return out


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,c,hw,groups", SHAPES)
def test_launch_plan_covers_every_element_once(n, c, hw, groups, elem_bytes):
    """The runs partition each group's samples; the threads of a run visit
    each of its vectors once (in the model of the kernel's loop above); a
    vector is a whole number of elements of a plane."""
    plan = bn.launch_plan(n, c, hw, groups, elem_bytes, sm_count=132)
    per_group = n // groups
    runs = [slice_samples(plan, per_group, s) for s in range(plan.slices)]
    assert [i for r in runs for i in r] == list(range(per_group))
    assert hw % plan.vector == 0 and plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    plane = hw // plan.vector
    for count in {len(r) for r in runs}:
        seen = [v for t in range(plan.threads)
                for v in thread_vectors(plane, count, plan.threads, t)]
        assert sorted(seen) == [(s, o) for s in range(count) for o in range(plane)]


def test_launch_plan_adapts_to_the_shape():
    """One run a pair on the 4x4 and 8x8 planes; many on the 128 px ones;
    enough blocks to fill the card where the pairs are few and large; one
    element a vector where a plane is no whole number of 16 bytes, or x is
    not aligned to them."""
    assert bn.launch_plan(128, 512, 16, 2, 2, 132).slices == 1
    assert bn.launch_plan(128, 256, 64, 2, 2, 132).slices == 1
    big = bn.launch_plan(256, 64, 128 * 128, 2, 2, 132)
    assert big.slices * big.samples == 128 and big.samples * 128 * 128 <= bn.BLOCK_ELEMENTS
    few = bn.launch_plan(64, 128, 32 * 32, 1, 2, 132)
    assert 128 * few.slices >= bn.BLOCKS_PER_SM * 132
    assert few.samples * 32 * 32 >= bn.MIN_BLOCK_ELEMENTS
    assert bn.launch_plan(6, 10, 15, 2, 2, 132).vector == 1
    assert bn.launch_plan(128, 64, 4096, 2, 2, 132).vector == 8
    assert bn.launch_plan(128, 64, 4096, 2, 4, 132).vector == 4
    assert bn.launch_plan(128, 64, 4096, 2, 2, 132, aligned=False).vector == 1


def on_card(dtype, shape):
    """A stand-in for a CUDA tensor: the route reads its device alone."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"), dtype=dtype,
                                 shape=shape)


def test_route_is_decided_by_what_the_call_observes():
    """The CPU takes the plain version; every call on the card the kernels
    (which refuse what they cannot take), whatever its dtype or shape; a
    data group the plain version with its all-reduce."""
    assert bc.route(torch.ones(2, 4, 3, 3), None) == "plain"
    for dtype, shape in ((torch.bfloat16, (2, 4, 3, 3)), (torch.float16, (2, 4, 3, 3)),
                         (F64, (2, 4, 3, 3)), (torch.bfloat16, (4,))):
        assert bc.route(on_card(dtype, shape), None) == "fused"
    assert bc.route(on_card(torch.bfloat16, (2, 4, 3, 3)), object()) == "plain_data_group"
    assert bc.route(torch.ones(2, 4), object()) == "plain_data_group"


def test_the_module_counts_its_route(monkeypatch):
    """On the CPU a call takes the plain version and counts nothing; with
    a data group it takes the plain version with the all-reduce between
    the passes (here a stand-in that sums one rank) and counts
    ``plain_data_group``."""
    reduced = []
    monkeypatch.setattr(bc, "all_reduce_sum", lambda t, mesh: reduced.append(mesh) or t)
    bn_module = GroupedBatchNorm(4, eps=1e-4, compute_dtype=F64).double().train()
    x = torch.randn(4, 4, 3, 3, dtype=F64)
    before = dict(bc.CALLS)
    want = bn_module(x, 2, 0.2)
    assert bc.CALLS == before and not reduced
    group = object()
    bn_module.data_group = group
    got = bn_module(x, 2, 0.2)
    assert reduced == [group]
    assert bc.CALLS == {"plain_data_group": before["plain_data_group"] + 1}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_eval_mode_applies_the_slope_after_the_running_statistics():
    bn_module = GroupedBatchNorm(3, compute_dtype=torch.bfloat16).eval()
    with torch.no_grad():
        bn_module.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn_module.running_var.copy_(torch.tensor([0.5, 1.5, 2.0]))
    x = torch.randn(2, 3, 4, 4).to(torch.bfloat16)
    assert torch.equal(bn_module(x, 1, 0.2), F.leaky_relu(bn_module(x, 1), 0.2))
