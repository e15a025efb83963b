"""The 'conv' and 'res' arch encoder/decoder, NCHW."""

from intro_tc_vae_tpu_torch.models.blocks import (
    ConvolutionalBlock,
    GroupedBatchNorm,
    PackedPredictConv,
    PallasConv3x3,
    ResidualBlock,
    StripTiledConv,
)
from intro_tc_vae_tpu_torch.models.vae import (
    Decoder,
    Encoder,
    SoftIntroVAE,
    conv_output_size,
    num_params,
    resolve_conv_impl,
    resolve_tile_rows,
    set_mesh,
)

__all__ = [
    "ConvolutionalBlock",
    "GroupedBatchNorm",
    "PackedPredictConv",
    "PallasConv3x3",
    "ResidualBlock",
    "StripTiledConv",
    "Decoder",
    "Encoder",
    "SoftIntroVAE",
    "conv_output_size",
    "num_params",
    "resolve_conv_impl",
    "resolve_tile_rows",
    "set_mesh",
]
