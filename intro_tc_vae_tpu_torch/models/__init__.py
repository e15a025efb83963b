"""The 'conv' arch encoder/decoder, NCHW."""

from intro_tc_vae_tpu_torch.models.blocks import ConvolutionalBlock, GroupedBatchNorm
from intro_tc_vae_tpu_torch.models.vae import (
    Decoder,
    Encoder,
    SoftIntroVAE,
    conv_output_size,
    num_params,
    resolve_conv_impl,
)

__all__ = [
    "ConvolutionalBlock",
    "GroupedBatchNorm",
    "Decoder",
    "Encoder",
    "SoftIntroVAE",
    "conv_output_size",
    "num_params",
    "resolve_conv_impl",
]
