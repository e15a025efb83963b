"""PyTorch port: the sampler (``intro_tc_vae_tpu_torch/sample.py``) and the
on-device u8 export, against the JAX package.

* ``unit_f32_to_u8`` is bit-equal to JAX's on the same float32 input,
  which holds every k/255, the floats one ulp either side of each, values
  outside [0, 1] and random ones.
* ``sample_grid`` equals JAX's.
* The CLI on the CPU writes a PNG that PIL decodes to the grid it returns,
  decoded from the checkpoint and the seed's noise.
* The same checkpoint and latents through the port's ``decode`` and
  through JAX's (fp32, eval mode) give u8 grids that are equal except where
  the float lies within 1e-5 of a level boundary k/255; those entries are
  counted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from intro_tc_vae_tpu.sample import sample_grid as jsample_grid
from intro_tc_vae_tpu.solvers.base import decode as jdecode
from intro_tc_vae_tpu.solvers.base import unit_f32_to_u8 as junit_f32_to_u8
from intro_tc_vae_tpu.utils.transplant import torch_state_dict_to_flax
from intro_tc_vae_tpu_torch import sample
from intro_tc_vae_tpu_torch.data import load_dataset
from intro_tc_vae_tpu_torch.models import Decoder, Encoder, SoftIntroVAE, conv_output_size
from intro_tc_vae_tpu_torch.solvers.base import decode, encode, unit_f32_to_u8
from intro_tc_vae_tpu_torch.utils import save_checkpoint
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
SMALL = dict(arch="conv", cdim=3, zdim=8, channels=(16, 32), image_size=32)
BOUNDARY = 1e-5


def _u8_inputs() -> np.ndarray:
    levels = np.arange(256, dtype=np.float32) / np.float32(255)
    up = np.nextafter(levels, np.float32(np.inf))
    down = np.nextafter(levels, np.float32(-np.inf))
    extra = np.array([-1.0, -0.0, 1.5, 2.0, np.float32(1) + np.float32(2**-23)], np.float32)
    rand = np.random.default_rng(0).random(4096, dtype=np.float32)
    return np.concatenate([levels, up, down, extra, rand]).astype(np.float32)


def test_unit_f32_to_u8_is_bit_equal_to_jax():
    x = _u8_inputs()
    got = unit_f32_to_u8(torch.from_numpy(x)).numpy()
    want = np.asarray(junit_f32_to_u8(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (np.clip(x, 0, 1) * 255).astype(np.uint8))
    assert set(np.unique(got[:256])) == set(range(256))


@pytest.mark.parametrize("shape,cols", [((16, 5, 7, 3), 8), ((5, 4, 4, 1), 8), ((3, 2, 3, 3), 2)])
def test_sample_grid_equals_jax(shape, cols):
    images = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = sample.sample_grid(images, cols)
    np.testing.assert_array_equal(got, jsample_grid(images, cols))
    assert got.dtype == np.uint8


def _checkpoint(tmp_path, seed: int = 0) -> tuple:
    """A checkpoint of the small model after a train-mode pass (BatchNorm
    statistics off their init), its predict conv scaled so that the images
    spread over [0, 1] (a fresh decoder's are all near 0.5); returns
    (path, model)."""
    from intro_tc_vae_tpu_torch.solvers import make_optimizer

    torch.manual_seed(seed)
    model = SoftIntroVAE(Encoder(**SMALL), Decoder(**SMALL))
    with torch.no_grad():
        model.decoder.main["predict"].weight.mul_(200.0)
    model.decoder(torch.randn(16, SMALL["zdim"]))
    model.encoder(torch.rand(16, 3, 32, 32))
    state = type("State", (), {})()
    state.model, state.step = model, 0
    state.opt_e = make_optimizer("adam", 1e-3)(model.encoder.parameters())
    state.opt_d = make_optimizer("adam", 1e-3)(model.decoder.parameters())
    return save_checkpoint(state, 0, 0, checkpoint_dir=str(tmp_path)), model


ARGV = ["--dataset", "synthetic_small", "--arch", "conv", "--z-dim", "8", "--num", "12",
        "--seed", "3"]


def test_cli_writes_the_decoded_grid_as_png(tmp_path):
    path, model = _checkpoint(tmp_path)
    out = str(tmp_path / "grid.png")
    grid = sample.main(["--checkpoint", path, *ARGV, "--out", out], device=CPU)
    assert grid.shape == (64, 256, 3) and grid.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(Image.open(out)), grid)

    z = torch.randn((12, 8), generator=torch.Generator(device=CPU).manual_seed(3))
    want = sample.to_host_u8(decode(model.decoder, z, train=False))
    np.testing.assert_array_equal(grid, sample.sample_grid(want))
    assert len(np.unique(grid)) > 100  # the images spread over the levels


def test_cli_reconstruct_stacks_data_reconstructions_and_samples(tmp_path):
    path, model = _checkpoint(tmp_path)
    out = str(tmp_path / "rec.png")
    grid = sample.main(["--checkpoint", path, *ARGV, "--num", "8", "--reconstruct",
                        "--out", out], device=CPU)
    assert grid.shape == (3 * 32, 8 * 32, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), grid)
    x = load_dataset("synthetic_small")[0].get_batch(np.arange(8))
    np.testing.assert_array_equal(grid[:32], np.concatenate(
        list((np.clip(x, 0, 1) * 255).astype(np.uint8)), axis=1))
    mu, _ = encode(model.encoder, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), train=False)
    rec = sample.to_host_u8(decode(model.decoder, mu, train=False))
    np.testing.assert_array_equal(grid[32:64], np.concatenate(list(rec), axis=1))


def test_cli_needs_cuda_unless_given_the_cpu(tmp_path, monkeypatch):
    path, _ = _checkpoint(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample.main(["--checkpoint", path, *ARGV, "--out", str(tmp_path / "x.png")])
    assert not os.path.exists(tmp_path / "x.png")


def test_cli_pack_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 9\)"):
        sample.main(["--checkpoint", "unused", *ARGV, "--pack", "2"], device=CPU)


def test_decode_u8_grid_matches_jax(tmp_path):
    """Same checkpoint, same latents, fp32 eval-mode decode in both packages:
    u8 grids equal except at entries whose float lies within 1e-5 of a
    level boundary (there one float32 rounding may change the level)."""
    from intro_tc_vae_tpu.models import Decoder as JDecoder

    _, model = _checkpoint(tmp_path)
    cos = conv_output_size(32, SMALL["channels"])
    params, stats = torch_state_dict_to_flax(model.state_dict(), "conv", cos)
    z = torch.randn((64, 8), generator=torch.Generator(device=CPU).manual_seed(5))
    got_f = decode(model.decoder, z, train=False).permute(0, 2, 3, 1).numpy()
    want_f, _ = jdecode(JDecoder(**SMALL), params["decoder"], stats["decoder"],
                        jnp.asarray(z.numpy()), train=False)
    want_f = np.asarray(want_f)
    got = sample.sample_grid(unit_f32_to_u8(torch.from_numpy(got_f)).numpy())
    want = sample.sample_grid(np.asarray(junit_f32_to_u8(jnp.asarray(want_f))))
    grid_f = sample.sample_grid(want_f)
    scaled = np.clip(grid_f, 0, 1) * 255
    near = np.abs(scaled - np.round(scaled)) < BOUNDARY * 255
    differ = got != want
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the count: how many entries lie that close to a boundary, how many differ
    print(f"{int(near.sum())} of {near.size} entries within {BOUNDARY} of a level "
          f"boundary; {int(differ.sum())} differ")
    assert differ.sum() <= near.sum() < 0.01 * near.size
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-6)
