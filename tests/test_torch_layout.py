"""PyTorch port: the layout rule of the stock convs (``models/blocks.py``
``conv_layout``, ``as_layout``, ``Conv2d._apply``) and what runs between
them on channels-last tensors.

On the card at a 16-bit compute dtype every conv the kernel gate does not
route reads and writes channels-last; everywhere else NCHW. The CPU keeps
NCHW, so here the rule is stood in for by the card's answer
(``card_rule``), and the models put channels-last that way give the NCHW
models' outputs and gradients within float32 rounding, for every arch, with
a data group's plain BatchNorm and the tensor-parallel gathers. A
recipe's counts a step (``bn_nhwc``: train-mode BatchNorm calls that take
the kernels' NHWC bodies; ``layout_copy``: conv inputs converted between
the layouts) are derived here from its encoder's and decoder's passes, as
the benchmark's ``nhwc_bn_calls.train`` reads them on the card. The NHWC
kernels themselves: ``tests/test_torch_bn_cuda.py``, on the card.
"""

import copy
import types

import pytest
import torch
import torch.nn.functional as F

from intro_tc_vae_tpu_torch.models import Decoder, Encoder
from intro_tc_vae_tpu_torch.models import blocks
from intro_tc_vae_tpu_torch.ops import batchnorm as bn
from intro_tc_vae_tpu_torch.ops import batchnorm_cuda as bc
from intro_tc_vae_tpu_torch.parallel import collectives
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

CL, NCHW = torch.channels_last, torch.contiguous_format
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device", [CUDA, CPU])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("routed", [False, True])
def test_the_layout_rule(device, dtype, routed):
    """The rule's table: NCHW for a routed conv, on the CPU and in fp32;
    channels-last for every other conv on the card at a 16-bit dtype."""
    card = device.type == "cuda" and dtype != torch.float32 and not routed
    assert blocks.conv_layout(device, dtype, routed) == (CL if card else NCHW)


def test_a_conv_observes_its_route():
    """``Conv2d.layout`` asks the gate with the call's shape: a 64 -> 64
    ``PallasConv3x3`` is routed at 64^2 and 128^2 and not at 256^2; a plain
    conv never is; the strip-tiled and packed convs stay NCHW."""
    dt = torch.bfloat16
    routed = blocks.PallasConv3x3(64, 64, compute_dtype=dt)
    for side, fmt in ((64, NCHW), (128, NCHW), (256, CL)):
        assert routed.layout((2, 64, side, side), CUDA) == fmt
    assert blocks.Conv2d(64, 64, 3, compute_dtype=dt).layout((2, 64, 64, 64), CUDA) == CL
    assert blocks.PallasConv3x3(64, 128, compute_dtype=dt).layout((2, 64, 64, 64), CUDA) == CL
    assert blocks.StripTiledConv(64, 64, 3, 16, compute_dtype=dt).layout(
        (2, 64, 64, 64), CUDA) == NCHW
    assert blocks.PackedPredictConv(64, 3, 2, compute_dtype=dt).layout(
        (2, 64, 64, 64), CUDA) == NCHW
    assert routed.layout((2, 64, 256, 256), CPU) == NCHW


def test_as_layout_converts_once_and_counts():
    """An input already in the layout is only cast; one in the other is
    copied once, cast with it, and counted in ``layout_copy``."""
    x = torch.randn(2, 8, 5, 5)
    start = blocks.LAYOUT["layout_copy"]
    same = blocks.as_layout(x, torch.float32, NCHW)
    assert same is x and blocks.LAYOUT["layout_copy"] == start
    y = blocks.as_layout(x, torch.bfloat16, CL)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=CL)
    assert not y.is_contiguous() and blocks.LAYOUT["layout_copy"] == start + 1
    assert torch.equal(y.float(), x.to(torch.bfloat16).float())
    assert blocks.as_layout(y, torch.bfloat16, CL) is y
    assert blocks.LAYOUT["layout_copy"] == start + 1


@pytest.fixture
def card_rule(monkeypatch):
    """The rule as the card answers it at bf16, for CPU tensors in any
    dtype: every conv the gate does not route runs channels-last."""
    rule = blocks.conv_layout
    monkeypatch.setattr(blocks, "conv_layout",
                        lambda device, dtype, routed: rule(CUDA, torch.bfloat16, routed))


def test_place_weights_lays_each_weight_once(card_rule):
    """At the flagship's widths, as the decoder is moved (to the CPU here,
    with the card's rule): every conv weight but the routed ones' (the
    decoder's 64 -> 64 convs at 32^2 and 64^2) lies channels-last, its
    values, ``state_dict`` and a ``copy_`` into it unchanged; a second move
    lays nothing anew."""
    torch.manual_seed(0)
    kw = dict(arch="conv", cdim=3, zdim=8, channels=(64, 128, 256, 512), image_size=64,
              conv_impl="pallas")
    dec = Decoder(**kw)
    convs = {n: m for n, m in dec.named_modules() if isinstance(m, blocks.Conv2d)}
    assert all(m.weight.is_contiguous() for m in convs.values())
    before = {k: v.clone() for k, v in dec.state_dict().items()}
    dec.to(CPU)
    routed = {"main.res_in_32.conv2", "main.res_in_64.conv1", "main.res_in_64.conv2"}
    for name, m in convs.items():
        assert m.weight.is_contiguous(memory_format=NCHW if name in routed else CL), name
    assert sum(not m.weight.is_contiguous() for m in convs.values()) == len(convs) - len(routed)
    after = dec.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    w = convs["main.res_in_8.conv1"].weight
    ptr = w.data_ptr()
    with torch.no_grad():
        w.copy_(before["main.res_in_8.conv1.weight"] * 2)
    assert w.data_ptr() == ptr and w.is_contiguous(memory_format=CL)
    assert torch.equal(w, before["main.res_in_8.conv1.weight"] * 2)
    ptrs = [m.weight.data_ptr() for m in convs.values()]
    dec.to(CPU)
    assert [m.weight.data_ptr() for m in convs.values()] == ptrs


def _grads(enc, dec, x, z, groups):
    xr, zr = x.clone().requires_grad_(True), z.clone().requires_grad_(True)
    mu, logvar = enc(xr, groups)
    img = dec(zr, groups)
    loss = (mu * 1.3).sum() + (logvar * 0.7).sum() + (img * img).sum()
    params = [*enc.parameters(), *dec.parameters()]
    return [mu, logvar, img, *torch.autograd.grad(loss, [xr, zr, *params])]


@pytest.mark.parametrize("data_group", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ["conv", "res", "inception"])
def test_channels_last_models_are_the_nchw_models(monkeypatch, arch, groups, data_group):
    """An encoder and decoder put channels-last by the card's rule and
    moved with it against the same modules in NCHW: mu, logvar, the
    image, the input and every parameter gradient within float32 rounding,
    the running statistics too; every train-mode BatchNorm of the
    channels-last models takes a channels-last x (a data group's plain
    version too, whose sums cross the ranks through a stand-in)."""
    torch.manual_seed(3)
    kw = dict(arch=arch, cdim=3, zdim=6, channels=(8, 16), image_size=16)
    enc, dec = Encoder(**kw).train(), Decoder(**kw).train()
    enc0, dec0 = copy.deepcopy(enc), copy.deepcopy(dec)
    x, z = torch.rand(4, 3, 16, 16), torch.randn(4, 6)
    want = _grads(enc0, dec0, x, z, groups)
    monkeypatch.setattr(bc, "all_reduce_sum", lambda t, mesh: t)
    rule = blocks.conv_layout
    monkeypatch.setattr(blocks, "conv_layout",
                        lambda device, dtype, routed: rule(CUDA, torch.bfloat16, routed))
    for net in (enc, dec):
        net.to(CPU)
    assert any(not m.weight.is_contiguous() for net in (enc, dec) for m in net.modules()
               if isinstance(m, blocks.Conv2d))
    for net in (enc, dec):
        for m in net.modules():
            if data_group and isinstance(m, blocks.GroupedBatchNorm):
                m.data_group = object()
    seen = []
    train = blocks.batchnorm_act_train
    monkeypatch.setattr(blocks, "batchnorm_act_train",
                        lambda t, *a, **k: seen.append(bc.nhwc(t)) or train(t, *a, **k))
    got = _grads(enc, dec, x, z, groups)
    assert seen and all(seen)
    for a, r in zip(got, want):
        scale = max(1.0, float(r.detach().abs().max()))
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * scale)
    for a, r in zip([*enc.buffers(), *dec.buffers()], [*enc0.buffers(), *dec0.buffers()]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-6)


def test_tensor_parallel_gathers_keep_channels_last_values(monkeypatch):
    """``gather_channels`` and ``copy_to_model`` of a channels-last slice
    (two ranks stood in for by a copy) give the values of the NCHW slice's,
    forward and backward."""
    def all_gather(parts, t, group):
        for p in parts:
            p.copy_(t)

    monkeypatch.setattr(collectives.dist, "all_gather", all_gather)
    monkeypatch.setattr(collectives.dist, "all_reduce", lambda t, group: t.mul_(2))
    group = types.SimpleNamespace(size=2, rank=1, group=None)
    x = torch.randn(2, 8, 5, 5)
    outs = []
    for t in (x, x.contiguous(memory_format=CL)):
        t = t.clone().requires_grad_(True)
        y = collectives.gather_channels(collectives.copy_to_model(t, group), group)
        g = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
        outs.append((y.detach(), torch.autograd.grad(y, t, g)[0]))
    assert outs[0][0].shape == (2, 16, 5, 5)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


class StandIn:
    """``_BatchNormAct`` as the CPU can run it: the plain version, then the
    stock pass of the resample the call was handed."""

    @staticmethod
    def apply(x, weight, bias, running, groups, eps, momentum, slope, resample=None):
        y = bn.batchnorm_act(x, weight, bias, running, groups, eps, momentum, slope, x.dtype)
        if resample == "pool":
            return F.avg_pool2d(y, 2)
        return y if resample is None else F.interpolate(y, scale_factor=2, mode="nearest")


# The three train cells' models: arch, image size, widths, z
RECIPES = {"itc64.train": ("conv", 64, (64, 128, 256, 512), 128),
           "itc128.train": ("conv", 128, (64, 128, 256, 512, 512), 128),
           "itc256res.train": ("res", 256, (64, 128, 256, 512, 512, 512), 512)}
# (bn_nhwc, layout_copy) of an encoder pass on the batch, a decoder pass, an
# encoder pass on the decoder's images, and a paired intro step: three encoder
# calls (the batch; rec and fake in phase E, again in phase D) and four
# decoder calls. Every BatchNorm after a stock conv takes the NHWC bodies,
# every one after a routed conv the NCHW ones (the decoder's 64 -> 64 convs
# at 32^2 and 64^2, or at 128^2). Copies: the batch's NCHW images into the
# stem (the decoder's images lie channels-last, as the predict conv writes
# them), the decoder's fc output into its first conv, a routed conv's
# channels-last input, and at 64 and 128 px the last routed block's output
# into the predict conv (at 256 px the routed block's residual sum lies as
# its channels-last projection)
COUNTS = {"itc64.train": ((9, 1), (7, 3), (9, 0), (55, 13)),
          "itc128.train": ((11, 1), (9, 3), (11, 0), (69, 13)),
          "itc256res.train": ((13, 1), (13, 2), (13, 0), (91, 9))}


@pytest.mark.parametrize("cell", list(RECIPES))
def test_a_step_counts_its_nhwc_calls_and_layout_copies(monkeypatch, card_rule, cell):
    """Each train cell's model at its widths and planes, on the card's rule
    and the kernels' route (stood in for): the ``bn_nhwc`` and
    ``layout_copy`` counts of its encoder on the batch, its decoder and
    its encoder on the decoder's images, and a step's: one of the first,
    four of the second, two of the third."""
    monkeypatch.setattr(bc, "route",
                        lambda x, group: "fused" if group is None else "plain_data_group")
    monkeypatch.setattr(bc, "_BatchNormAct", StandIn)
    arch, size, channels, zdim = RECIPES[cell]
    torch.manual_seed(0)
    kw = dict(arch=arch, cdim=3, zdim=zdim, channels=channels, image_size=size,
              conv_impl="pallas")
    enc, dec = Encoder(**kw).train(), Decoder(**kw).train()
    for net in (enc, dec):
        net.to(CPU)
    passes, images = [], None
    with torch.no_grad():
        for net, inp in ((enc, torch.rand(2, 3, size, size)), (dec, torch.randn(2, zdim)),
                         (enc, None)):
            start = (bc.CALLS["bn_nhwc"], blocks.LAYOUT["layout_copy"])
            out = net(images if inp is None else inp, 1)
            images = out if net is dec else images
            passes.append((bc.CALLS["bn_nhwc"] - start[0],
                           blocks.LAYOUT["layout_copy"] - start[1]))
    step = tuple(a + 4 * b + 2 * c for a, b, c in zip(*passes))
    assert (*passes, step) == COUNTS[cell]


def test_on_the_cpu_nothing_is_channels_last():
    """Without the stand-in rule a model on the CPU converts nothing and
    lays no weight channels-last: the path the JAX comparisons take."""
    kw = dict(arch="conv", cdim=3, zdim=8, channels=(64, 128), image_size=16,
              conv_impl="pallas", compute_dtype=torch.bfloat16)
    enc, dec = Encoder(**kw).train().to(CPU), Decoder(**kw).train().to(CPU)
    assert all(p.is_contiguous() for p in [*enc.parameters(), *dec.parameters()])
    start = blocks.LAYOUT["layout_copy"]
    with torch.no_grad():
        dec(enc(torch.rand(2, 3, 16, 16))[0], 1)
    assert blocks.LAYOUT["layout_copy"] == start


def test_the_reader_reads_the_nhwc_calls_a_step(monkeypatch):
    """``nhwc_bn_calls.train``: ``bn_nhwc`` over the graphed step's calls;
    None without a graphed step, and where the counter is absent (the
    parent's program) or zero."""
    from perfbench.core import spec

    from intro_tc_vae_tpu_torch.solvers.graph import GraphedStep
    from intro_tc_vae_tpu_torch.utils import tracing

    read = spec.metric_reader("nhwc_bn_calls.train")
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=64, phase_capacity=8))
    saved = dict(bc.CALLS)
    try:
        bc.CALLS["bn_nhwc"] = 0
        assert read(None) is None  # no graphed step
        graphed = GraphedStep(lambda *a: {}, (), 1)
        graphed.eager, graphed.replays = 3, 5
        assert read(None) is None  # the counter zero: left out, as on the parent
        bc.CALLS["bn_nhwc"] = 8 * 55
        assert read(None) == pytest.approx(55.0)
    finally:
        bc.CALLS.update(saved)


def test_relayout_off_the_card_is_the_stock_copy():
    """``ops/layout_cuda.py::relayout`` on the CPU: PyTorch's copy into the
    layout, the same values; the kernel takes no CPU tensor."""
    from intro_tc_vae_tpu_torch.ops import layout_cuda

    x = torch.randn(2, 6, 3, 5)
    for fmt, src in ((CL, x), (NCHW, x.contiguous(memory_format=CL))):
        assert not layout_cuda.takes(src, fmt)
        y = layout_cuda.relayout(src, fmt)
        assert y.is_contiguous(memory_format=fmt) and torch.equal(y, x)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layout kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("shape", [(128, 64, 64, 64), (64, 3, 256, 256), (128, 512, 4, 4),
                                   (3, 5, 7, 9), (2, 33, 31, 65)])
def test_relayout_moves_every_element_and_its_gradient(dev, shape, dtype):
    """The kernel both ways, bit for bit PyTorch's copy, each launch
    counted; the gradient moved back to the input's layout, bit for bit."""
    from intro_tc_vae_tpu_torch.ops import layout_cuda

    x = torch.randn(shape, device=dev).to(dtype)
    for fmt, src in ((CL, x), (NCHW, x.contiguous(memory_format=CL))):
        assert layout_cuda.takes(src, fmt)
        before = layout_cuda.LAUNCHES["relayout"]
        src = src.clone().requires_grad_(True)
        y = layout_cuda.relayout(src, fmt)
        assert layout_cuda.LAUNCHES["relayout"] == before + 1
        assert y.is_contiguous(memory_format=fmt) and torch.equal(y, x)
        g = torch.randn(shape, device=dev).to(dtype)
        (dx,) = torch.autograd.grad(y, src, g)
        assert dx.stride() == src.stride() and torch.equal(dx, g)
