"""Host-side data: the ``Synthetic`` dataset and a one-device loader."""

from intro_tc_vae_tpu_torch.data.datasets import (
    Synthetic,
    factor_bases,
    index_to_factor,
    load_dataset,
)
from intro_tc_vae_tpu_torch.data.loader import DeviceLoader

__all__ = [
    "Synthetic",
    "factor_bases",
    "index_to_factor",
    "load_dataset",
    "DeviceLoader",
]
