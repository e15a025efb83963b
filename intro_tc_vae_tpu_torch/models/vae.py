"""Encoder / Decoder of the 'conv' and 'res' archs, NCHW.

Counterpart of ``intro_tc_vae_tpu/models/vae.py`` (topology of reference
models.py:196-298):

* Encoder: 5x5 stem conv -> BN(1e-4) -> LReLU -> AvgPool/2, then per
  stage {block, AvgPool/2} over channels[1:], a final same-width block,
  and a Linear head producing 2*z_dim chunked into (mu, logvar).
* Decoder: Linear z_dim -> conv features + LReLU, mirrored {block,
  nearest x2 upsample} stages, a final block, 5x5 predict conv (with
  bias) + sigmoid.

Module names follow the reference torch model (``encoder.main.0`` stem
conv, ``encoder.main.1`` stem BN, ``*.main.res_in_{sz}``, ``encoder.fc``,
``decoder.fc.0``, ``decoder.main.predict``), so the JAX package's
``utils/transplant.py::torch_state_dict_to_flax`` reads this port's
``state_dict()`` as it is. The fc layers flatten NCHW like the
reference; the JAX package flattens NHWC, and the weight bridge
(utils/transplant.py) permutes between the two.

Train/eval follow ``module.train()``/``module.eval()``. mu, logvar and
the pre-sigmoid output are cast to float32 whatever the conv dtype.

``tile_rows > 0`` makes every conv with kernel > 1, the stem and the
predict conv included, a ``StripTiledConv``; ``Decoder(pack_predict=b)``
with b > 1 and an image size that b divides computes the predict conv
output-packed (``PackedPredictConv``; JAX ``models/vae.py:187-193``). Both
keep the plain conv's parameters.

``remat=True`` (config ``remat: true | "block"``; JAX
``models/vae.py:104-118``, ``:161-167``) recomputes each encoder and
decoder block in the backward (``blocks.remat``); the stem, the fc layers
and the predict conv stay outside, as in JAX. The recompute runs the
tensor-parallel collectives of its region again, in the same order on
every rank (every rank recomputes the same regions of the same graph).

Tensor parallelism (``parallel.shard_state``; the layouts are
``models/blocks.py``'s): at the flagship width the encoder fc [2z, h w c]
is row-parallel. Its input features in NCHW flatten order are
channel-major, so the last block's channel slice, flattened, is this
rank's contiguous slice of them and feeds it directly, and
``reduce_from_model`` sums the partial products. JAX's NHWC flatten puts
the same cut elsewhere in the feature axis (a slice of rows of the
image, not of channels); both compute the same function, each the sum of
its partial products. The decoder fc [h w c, z] is column-parallel: its
output slice is, in NCHW order, the channel slice [B, c/M, h, w] the
first block takes. mu, logvar and the image are whole on every rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from intro_tc_vae_tpu_torch.models.blocks import (
    LEAKY_SLOPE,
    GroupedBatchNorm,
    Linear,
    whole,
    PackedPredictConv,
    avg_pool2,
    conv,
    get_conv_class,
    remat,
    upsample_nearest2,
)


def conv_output_size(image_size: int, channels: Sequence[int]) -> Tuple[int, int, int]:
    """Static (h, w, c) of the encoder conv stack output: one AvgPool/2 in
    the stem plus one per channels[1:] stage."""
    sz = image_size // (2 ** len(channels))
    if sz < 1:
        raise ValueError(
            f"image_size {image_size} too small for {len(channels)} downsamples"
        )
    return (sz, sz, channels[-1])


def resolve_tile_rows(tile_rows: int, image_size: int) -> int:
    """Resolve the config ``tile_rows`` knob (JAX ``models/vae.py:56``):
    -1 (auto) is off at every image size until a measurement on the card
    decides otherwise; a value >= 0 passes through."""
    if tile_rows >= 0:
        return tile_rows
    return 0


def resolve_conv_impl(conv_impl: str) -> str:
    """Resolve the config ``conv_impl`` knob: 'auto' -> 'xla' (the stock
    conv) until a benchmark on the card has measured the 'xla' and
    'pallas' arms against each other."""
    if conv_impl == "auto":
        return "xla"
    return conv_impl


def run_block(block: nn.Module, y: torch.Tensor, groups: int, checkpointed: bool):
    """One block's forward, recomputed in the backward when ``checkpointed``
    and a graph is being built."""
    if checkpointed and torch.is_grad_enabled():
        return remat(block, block, y, groups)
    return block(y, groups)


class Encoder(nn.Module):
    """Conv encoder producing (mu, logvar). Reference models.py:196-244."""

    def __init__(self, arch: str = "res", cdim: int = 3, zdim: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512, 512, 512),
                 image_size: int = 256, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0, remat: bool = False):
        super().__init__()
        block = get_conv_class(arch)
        self.cdim, self.zdim, self.image_size = cdim, zdim, image_size
        self.channels = tuple(channels)
        self.remat = remat
        dt = compute_dtype
        cc = channels[0]
        self.main = nn.ModuleDict()
        self.main["0"] = conv(cdim, cc, 5, compute_dtype=dt, tile_rows=tile_rows)
        self.main["1"] = GroupedBatchNorm(cc, eps=1e-4, compute_dtype=dt)
        sz = image_size // 2
        self.stages = []
        for ch in channels[1:]:
            self.stages.append(f"res_in_{sz}")
            self.main[self.stages[-1]] = block(cc, ch, compute_dtype=dt,
                                               conv_impl=conv_impl, tile_rows=tile_rows)
            cc, sz = ch, sz // 2
        self.stages.append(f"res_in_{sz}")
        self.main[self.stages[-1]] = block(cc, cc, compute_dtype=dt,
                                           conv_impl=conv_impl, tile_rows=tile_rows)
        h, w, c = self.conv_output_size
        self.fc = Linear(h * w * c, 2 * zdim, compute_dtype=dt)

    @property
    def conv_output_size(self) -> Tuple[int, int, int]:
        return conv_output_size(self.image_size, self.channels)

    def forward(self, x: torch.Tensor, groups: int = 1):
        y = avg_pool2(self.main["1"](self.main["0"](x), groups, LEAKY_SLOPE))
        for name in self.stages[:-1]:
            y = avg_pool2(run_block(self.main[name], y, groups, self.remat))
        y = run_block(self.main[self.stages[-1]], y, groups, self.remat)
        y = whole(self.fc(y.flatten(1)), 2 * self.zdim, getattr(self.fc, "model_group", None))
        # loss math runs in fp32 regardless of the conv compute dtype
        mu, logvar = y.float().chunk(2, dim=1)
        return mu, logvar


class Decoder(nn.Module):
    """Conv decoder mapping z -> image in [0, 1]. Reference models.py:247-298.
    ``pack_predict`` > 1: the predict conv output-packed (0 or 1: plain)."""

    def __init__(self, arch: str = "res", cdim: int = 3, zdim: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512, 512, 512),
                 image_size: int = 256, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", tile_rows: int = 0, remat: bool = False,
                 pack_predict: int = 0):
        super().__init__()
        block = get_conv_class(arch)
        self.cdim, self.zdim, self.image_size = cdim, zdim, image_size
        self.channels = tuple(channels)
        self.remat = remat
        dt = compute_dtype
        cc = channels[-1]
        self.conv_input_size = conv_output_size(image_size, channels)
        h, w, c = self.conv_input_size
        # index 0 is the Linear: state_dict key decoder.fc.0.*
        self.fc = nn.Sequential(Linear(zdim, h * w * c, compute_dtype=dt),
                                nn.LeakyReLU(0.2))
        self.main = nn.ModuleDict()
        sz = h
        self.stages = []
        for ch in channels[::-1]:
            self.stages.append(f"res_in_{sz}")
            self.main[self.stages[-1]] = block(cc, ch, compute_dtype=dt,
                                               conv_impl=conv_impl, tile_rows=tile_rows)
            cc, sz = ch, sz * 2
        self.stages.append(f"res_in_{sz}")
        self.main[self.stages[-1]] = block(cc, cc, compute_dtype=dt,
                                           conv_impl=conv_impl, tile_rows=tile_rows)
        if pack_predict > 1 and sz % pack_predict == 0:
            self.main["predict"] = PackedPredictConv(cc, cdim, pack_predict, compute_dtype=dt)
        else:
            self.main["predict"] = conv(cc, cdim, 5, compute_dtype=dt, tile_rows=tile_rows,
                                        bias=True)

    def forward(self, z: torch.Tensor, groups: int = 1) -> torch.Tensor:
        h, w, c = self.conv_input_size
        group = getattr(self.fc[0], "model_group", None)
        y = self.fc(z.reshape(z.shape[0], -1))  # LReLU limits the pre-conv range
        if y.shape[1] % (h * w):  # a feature slice that is no channel slice
            y = whole(y, h * w * c, group)
        y = y.reshape(z.shape[0], -1, h, w)
        for name in self.stages[:-1]:
            y = upsample_nearest2(run_block(self.main[name], y, groups, self.remat))
        y = run_block(self.main[self.stages[-1]], y, groups, self.remat)
        y = whole(self.main["predict"](y), self.cdim, group)
        # sigmoid + reconstruction losses in fp32
        return torch.sigmoid(y.float())


class SoftIntroVAE(nn.Module):
    """Holds the encoder and the decoder, so that ``state_dict()`` carries
    the reference model's ``encoder.*`` / ``decoder.*`` keys."""

    def __init__(self, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder


def set_mesh(module: nn.Module, mesh) -> None:
    """Hand a mesh (``parallel.make_mesh``, or None) to ``module``: its
    data group, when it has several ranks, to every ``GroupedBatchNorm``,
    whose train-mode statistics become the global batch's; its model
    group (None without a model axis) to every module, which gathers or
    slices by it (``models/blocks.py``)."""
    data = mesh if mesh is not None and mesh.size > 1 else None
    model = None if mesh is None else mesh.model
    for m in module.modules():
        m.model_group = model
        if isinstance(m, GroupedBatchNorm):
            m.data_group = data


def num_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
