"""The graphed eval passes on the card (marker ``cuda``): the bench's
serving surfaces (``intro_tc_vae_tpu_torch/bench.py::surfaces``) and the
``make_eval_encoder`` of a solver whose step is graphed run as captured
CUDA graphs (``solvers/graph.py::GraphedEval``; the encoder's two shapes in
one pool), bit-equal to their eager passes, also after BatchNorm's running
statistics have moved in place under a graph captured before. They need
a CUDA device and skip without one; this file imports no jax (the card
host has none), so it runs there with
``python -m pytest --noconftest -q -m cuda tests/test_torch_bench_cuda.py``.
The CPU side, against the JAX package, is tests/test_torch_bench.py.
"""

import numpy as np
import pytest
import torch

from intro_tc_vae_tpu_torch import bench
from intro_tc_vae_tpu_torch.solvers.graph import GraphedEval

pytestmark = pytest.mark.cuda
B = 16


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured only on a card")
    monkeypatch.setattr(bench, "CHANNELS", {32: (16, 32)})
    monkeypatch.setattr(bench, "ZDIM", 16)
    return torch.device("cuda", 0)


def _move_statistics(model) -> None:
    """A train-mode pass: BatchNorm's running statistics move in place."""
    model.train()
    with torch.no_grad():
        model.decoder(torch.randn(B, 16, device="cuda"))
        model.encoder(torch.rand(B, 3, 32, 32, device="cuda"))


@pytest.mark.parametrize("pack", [0, 4])
def test_graphed_surfaces_are_bit_equal_to_eager(dev, pack):
    _, state, inputs = bench.build_infer(B, 32, "conv", pack, dev)
    for name, fn in bench.surfaces(state).items():
        graphed = GraphedEval(fn, (state.model,))
        inp = inputs[name]
        other = torch.rand_like(inp) if inp.dim() == 4 else torch.randn_like(inp)
        graphed(inp)
        graphed(inp)  # the capture
        assert graphed.captures == 1
        for x in (other, inp):
            got = graphed(x).clone()
            assert torch.equal(got, fn(x)), name
        _move_statistics(state.model)
        got = graphed(inp).clone()
        assert graphed.captures == 1 and torch.equal(got, fn(inp)), name
        if name == "decode_u8":
            assert got.dtype == torch.uint8


def test_graphed_eval_encoder_is_bit_equal_to_eager(dev):
    images = np.random.default_rng(0).random((2 * B + 5, 32, 32, 3), dtype=np.float32)
    solver, state, _ = bench.build_solver("vae", B, 32, dev, graph=False, beta_kl=0.5,
                                          beta_rec=0.75)
    solver.make_eval_encoder(state)(images[:B])
    assert solver._eval_encode is None  # an eager step: an eager encoder
    solver, state, _ = bench.build_solver("vae", B, 32, dev, graph=True, beta_kl=0.5,
                                          beta_rec=0.75)
    graphed, eager = solver.make_eval_encoder(state), solver.make_eval_encoder(state, eager=True)
    for _ in range(2):  # eager warm-up, then the captures
        graphed(images[:B])
        graphed(images[-5:])
    assert solver._eval_encode.captures == 2
    assert len({e[0].pool() for e in solver._eval_encode._graphs.values()}) == 1  # one pool
    _move_statistics(state.model)
    for batch in (images[B:2 * B], images[-5:]):
        for got, want in zip(graphed(batch), eager(batch)):
            np.testing.assert_array_equal(got, want)
    assert solver._eval_encode.captures == 2
