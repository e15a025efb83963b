"""Native runtime components (the C++ host-side data core, ctypes-bound;
counterpart of ``intro_tc_vae_tpu/runtime``)."""

from intro_tc_vae_tpu_torch.runtime.native import (
    available as native_available,
    flip_horizontal,
    gather,
    gather_normalize,
    gather_u8,
    resize_bicubic,
)

__all__ = [
    "native_available",
    "gather_normalize",
    "gather",
    "gather_u8",
    "resize_bicubic",
    "flip_horizontal",
]
