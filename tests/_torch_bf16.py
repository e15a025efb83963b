"""How far two bf16 implementations of one network may drift apart: shared
by the bf16 parity tests of the models and of the train step.

bf16 keeps 8 significant bits: an operation that rounds its result to bf16
changes it by at most 2^-8 relative (unit roundoff, one unit in the last
place; half of it when rounding to nearest). The JAX package and the port
round at the same places, the output of every conv, dense layer, BatchNorm,
leaky ReLU and average pool, but not the same way inside one: flax adds a
bias in bf16 after the product was rounded, PyTorch before; XLA's average
pool adds four bf16 values one at a time, PyTorch's adds them in float32.
So after L rounded layers two outputs differ by up to L * 2^-8 of the
largest entry, each layer's difference carried forward without growth
(BatchNorm renormalizes every block); and since the roundings are
independent, by about sqrt(L) * 2^-8 in the root-mean-square, which is also
the scale for a mean over many entries (a loss, a batch statistic).
"""

import math

import numpy as np
from torch import nn

from intro_tc_vae_tpu_torch.models.blocks import GroupedBatchNorm

U = 2.0 ** -8


def rounded_layers(net) -> int:
    """Operations of a port Encoder or Decoder whose result is rounded to
    bf16: every conv and dense layer, every BatchNorm and the leaky ReLU
    after it, the encoder's average pools (one after the stem and after
    every stage but the last: as many as stages) and the leaky ReLU after
    the decoder's dense layer. Nearest-neighbour upsampling copies."""
    n = 0
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            n += 1
        elif isinstance(m, GroupedBatchNorm):
            n += 2
    is_encoder = isinstance(net.fc, nn.Linear)
    return n + (len(net.stages) if is_encoder else 1)


def assert_close_bf16(got, want, layers: int, err_msg: str = "", scale: float = 1.0):
    """Every entry within scale * layers * 2^-8 of the largest reference
    entry, and the whole within scale * sqrt(layers) * 2^-8 in the 2-norm."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    worst = float(np.abs(got - want).max())
    bound = scale * layers * U * float(np.abs(want).max())
    assert worst <= bound, f"{err_msg}: max |d| {worst:.3g} > {bound:.3g}"
    norm = float(np.linalg.norm(got - want))
    bound = scale * math.sqrt(layers) * U * float(np.linalg.norm(want))
    assert norm <= bound, f"{err_msg}: |d|_2 {norm:.3g} > {bound:.3g}"
