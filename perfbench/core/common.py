"""Helpers every mode's driver shares: the model's shape from a cell, the
reference's TF32-off block, and a wait for the device."""

from __future__ import annotations

import contextlib

import torch

from perfbench.reference import model as ref


def arch_of(cell) -> ref.Arch:
    """The reference's shape of the cell's model: its blocks are
    ``config.arch``'s; an arch the reference has no blocks for raises."""
    m, c = cell.config["model"], cell.config["config"]
    return ref.Arch(image_size=m["image_size"], channels=tuple(m["channels"]),
                    cdim=m["cdim"], zdim=c["z_dim"], block=c["arch"])


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
