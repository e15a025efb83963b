"""The benchmark's CPU tests: ``python -m pytest perfbench/tests -q`` from
the checkout's root (``-m cuda`` on the card: ``--noconftest`` is not
needed, this file imports no JAX). Cells are cut to ``synthetic_small``
widths here; the card runs them at full size."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the repo's training tests run."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def small_cell(workload: str, batch: int = 8):
    """``workload`` at ``synthetic_small`` widths (32 px, channels 16-32,
    z 16) in float32, with a corpus and a request of a few images."""
    from perfbench.core import spec

    cell = copy.deepcopy(spec.cell(workload, ROOT))
    cell.config["model"] = {"image_size": 32, "channels": [16, 32], "cdim": 3}
    cell.config["config"].update(batch_size=batch, precision="fp32", z_dim=16)
    if cell.mode == "train":
        cell.traffic.update(corpus_images=8 * batch, warmup_steps=1)
    else:
        cell.traffic.update(batch=batch, latent_sets=4, checked_requests=3,
                            warmup_requests=2)
    return cell


@pytest.fixture
def small():
    return small_cell
