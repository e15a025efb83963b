"""InceptionV3 feature extractor (pool3, 2048-d) for standard FID.

Counterpart of ``intro_tc_vae_tpu/models/inception.py``, which targets
**pytorch-fid parity exactly**: the trunk is torchvision's inception_v3
(BasicConv2d = conv (bias-free) + BN (eps 1e-3, running statistics) +
ReLU; Mixed_5*/6*/7* blocks) with pytorch-fid's FID-net patches — avg
pools use count_include_pad=False (FIDInceptionA/C/E_1) and Mixed_7c's
branch_pool is a 3x3/s1/p1 MAX pool (FIDInceptionE_2). The modules keep
torchvision's names, so pytorch-fid's ``pt_inception-2015-12-05``
state_dict (or a torchvision one) loads with ``load_state_dict``;
``load_inception_weights`` drops its ``fc.*`` and ``AuxLogits.*`` entries.

Pretrained weights are not bundled and nothing is downloaded:
:func:`inception_feature_fn` is gated on a local weights file
(:func:`find_weights`) and callers fall back to encoder-FID
(``evaluation/fid.py``) when it is absent.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WEIGHTS_ENV = "ITCVAE_INCEPTION_WEIGHTS"
DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/itcvae/inception_v3.pth")

Pad = Union[int, Sequence[int]]


class BasicConv2d(nn.Module):
    """Bias-free conv, BatchNorm with its running statistics (eps 1e-3),
    ReLU; the BN never uses batch statistics (flax's
    ``use_running_average=True``)."""

    def __init__(self, inc: int, outc: int, kernel: Pad, stride: int = 1,
                 padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(inc, outc, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(outc, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=bn.eps)
        return F.relu(x)


def _maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3x3s1p1(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, inc: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inc, 64, 1)
        self.branch5x5_1 = BasicConv2d(inc, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(inc, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(inc, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3x3s1p1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, inc: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(inc, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(inc, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool3x3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, inc: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inc, 192, 1)
        self.branch7x7_1 = BasicConv2d(inc, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(inc, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(inc, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avgpool3x3s1p1(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, inc: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(inc, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(inc, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _maxpool3x3s2(x)], dim=1)


class InceptionE(nn.Module):
    """pool='avg' is pytorch-fid's FIDInceptionE_1 (Mixed_7b: avg_pool
    with count_include_pad=False); pool='max' is FIDInceptionE_2
    (Mixed_7c: branch_pool on a 3x3/s1/p1 MAX pool, as the original
    TF-graph FID network)."""

    def __init__(self, inc: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(inc, 320, 1)
        self.branch3x3_1 = BasicConv2d(inc, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(inc, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(inc, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avgpool3x3s1p1(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """Images in [0, 1], NCHW, any size -> pool3 features [B, 2048].

    Input handling is the JAX module's (pytorch-fid's): grey repeated to 3
    channels, a bilinear resize to 299x299 and 2x - 1 before the trunk.
    ``jax.image.resize`` is half-pixel bilinear with antialiasing when it
    downsamples; ``F.interpolate(..., align_corners=False,
    antialias=True)`` computes the same (tests/test_torch_fid.py holds an
    upsampling and a downsampling size to the JAX network)."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=True)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3x3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3x3s2(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # global average pool -> [B, 2048]


def load_inception_weights(model: InceptionV3Features, path: str) -> InceptionV3Features:
    """Load a torch state_dict (.pth) into ``model``: a plain
    ``load_state_dict`` of every entry but ``fc.*`` and ``AuxLogits.*``
    (the counterpart of the JAX ``load_torch_inception_weights``). Only
    ``num_batches_tracked`` may be missing (pytorch-fid's file has none)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith(("fc.", "AuxLogits."))}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: not an InceptionV3 state_dict (missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]})")
    return model


def find_weights(path: Optional[str] = None) -> Optional[str]:
    """Resolve a weights file: explicit arg > $ITCVAE_INCEPTION_WEIGHTS >
    the default cache path. None when nothing exists (offline gate)."""
    for cand in (path, os.environ.get(WEIGHTS_ENV), DEFAULT_WEIGHTS):
        if cand and os.path.exists(cand):
            return cand
    return None


def inception_feature_fn(weights_path: Optional[str] = None, device=None):
    """The standard-FID feature function, NHWC numpy images in [0, 1] ->
    [B, 2048] numpy features computed on ``device`` (cuda:0 unless the
    caller passes another) in fp32 with TF32 off; None when no weights
    file is available locally (callers then use encoder-FID)."""
    resolved = find_weights(weights_path)
    if resolved is None:
        return None
    from intro_tc_vae_tpu_torch.parallel.distributed import rank_device
    from intro_tc_vae_tpu_torch.train import true_fp32

    device = rank_device() if device is None else torch.device(device)
    model = load_inception_weights(InceptionV3Features(), resolved).to(device).eval()

    def feature_fn(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(images, np.float32)))
        with torch.inference_mode(), true_fp32("fp32"):
            return model(x.to(device).permute(0, 3, 1, 2)).cpu().numpy()

    return feature_fn
