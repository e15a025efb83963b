"""Host-side data pipeline feeding NCHW batches to the device
(counterpart of ``intro_tc_vae_tpu/data``): the datasets of reference
dataset.py and ``Synthetic``, ``load_image``, and ``DeviceLoader`` with its
prefetch thread, uint8 transfer and device-resident cache."""

from intro_tc_vae_tpu_torch.data.datasets import (
    DisentanglementDataset,
    DSprites,
    DSpritesSmall,
    MPI3D,
    MPI3DSmall,
    Synthetic,
    UkiyoE,
    factor_bases,
    get_spaced_elements,
    index_to_factor,
    load_dataset,
)
from intro_tc_vae_tpu_torch.data.image import load_image
from intro_tc_vae_tpu_torch.data.loader import DeviceLoader, WrappedDataLoader

__all__ = [
    "DisentanglementDataset",
    "DSprites",
    "DSpritesSmall",
    "MPI3D",
    "MPI3DSmall",
    "Synthetic",
    "UkiyoE",
    "factor_bases",
    "get_spaced_elements",
    "index_to_factor",
    "load_dataset",
    "DeviceLoader",
    "WrappedDataLoader",
    "load_image",
]
