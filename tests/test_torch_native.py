"""PyTorch port, the native data core (``intro_tc_vae_tpu_torch/runtime``):
the six entry points against numpy and PIL and against the JAX package's,
and how the library is built.

The port's native path is compared with the JAX package's native path
only when both libraries load; otherwise both sides take their numpy/PIL
fallbacks (``_load`` patched to return None), which are copies of each
other. Resize is held to the JAX test's bound against PIL
(tests/test_runtime_native.py): at most one uint8 step anywhere, exact
on 99 % of the values. Nothing here builds at import: the library is built
by the first call of an entry point.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from intro_tc_vae_tpu.runtime import native as jnative
from intro_tc_vae_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def both_paths(monkeypatch):
    """Both packages on the same path: native where both libraries load,
    else both on their fallbacks. Returns the path's name."""
    if native.available() and jnative.available():
        return "native"
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    return "fallback"


@pytest.fixture(params=["active", "fallback"])
def path(request, monkeypatch):
    """The port on the path this host has ('active': native where g++
    builds it) and on the numpy/PIL fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def _u8(rng, *shape):
    return rng.randint(0, 256, size=shape, dtype=np.uint8)


def test_gather_normalize_equals_numpy_divide(path):
    rng = np.random.RandomState(0)
    imgs = _u8(rng, 10, 8, 8, 3)
    idx = np.array([3, 1, 7, 3])
    out = native.gather_normalize(imgs, idx)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, imgs[idx].astype(np.float32) / 255.0)


def test_every_uint8_value_normalizes_like_numpy(path):
    imgs = np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1)
    out = native.gather_normalize(imgs, np.arange(256))
    np.testing.assert_array_equal(out.ravel(), np.arange(256, dtype=np.float32) / 255.0)


def test_gather_f32_and_u8_equal_numpy(path):
    rng = np.random.RandomState(1)
    f = rng.rand(10, 4, 4, 1).astype(np.float32)
    u = _u8(rng, 10, 5, 6, 3)
    idx = np.array([9, 0, 4])
    np.testing.assert_array_equal(native.gather(f, idx), f[idx])
    got = native.gather_u8(u, idx)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, u[idx])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_flip_equals_numpy(path, dtype):
    rng = np.random.RandomState(2)
    batch = (rng.rand(5, 6, 7, 3) * 255).astype(dtype)
    flags = np.array([1, 0, 1, 1, 0], np.uint8)
    want = batch.copy()
    want[flags == 1] = want[flags == 1, :, ::-1, :]
    out = native.flip_horizontal(batch.copy(), flags)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, want)


def test_flip_needs_one_flag_a_row():
    with pytest.raises(ValueError, match="2 flags for a batch of 3"):
        native.flip_horizontal(np.zeros((3, 2, 2, 1), np.float32), np.ones(2, np.uint8))


@pytest.mark.parametrize("src,dst", [(256, 64), (256, 128), (64, 64), (32, 48)])
def test_resize_within_one_uint8_step_of_pil(path, src, dst):
    from PIL import Image

    rng = np.random.RandomState(0)
    img_u8 = _u8(rng, src, src, 3)
    ours = native.resize_bicubic(img_u8[None].astype(np.float32) / 255.0, dst, dst)[0]
    ref = np.asarray(Image.fromarray(img_u8).resize((dst, dst), Image.BICUBIC),
                     np.float32) / 255.0
    assert np.abs(ours - ref).max() <= 1.0 / 255.0 + 1e-6
    assert (np.abs(ours - ref) < 1e-6).mean() > 0.99


def test_identity_resize_quantizes_to_uint8_steps(path):
    """Output on uint8 steps: the native core rounds to the nearest step
    (its PIL emulation), the fallback hands PIL ``(x * 255).astype(uint8)``,
    which truncates."""
    rng = np.random.RandomState(0)
    batch = rng.rand(2, 16, 16, 1).astype(np.float32)
    out = native.resize_bicubic(batch, 16, 16)
    np.testing.assert_array_equal(np.round(out * 255) / 255, out)
    step = 0.5 if native.available() else 1.0
    np.testing.assert_allclose(out, np.clip(batch, 0, 1), rtol=0, atol=step / 255.0)


def test_every_entry_point_equals_the_jax_package(both_paths):
    rng = np.random.RandomState(3)
    u = _u8(rng, 12, 16, 16, 3)
    f = rng.rand(12, 16, 16, 1).astype(np.float32)
    idx = rng.randint(0, 12, size=7)
    flags = (rng.rand(7) < 0.5).astype(np.uint8)
    pairs = [
        (native.gather_normalize(u, idx), jnative.gather_normalize(u, idx)),
        (native.gather(f, idx), jnative.gather(f, idx)),
        (native.gather_u8(u, idx), jnative.gather_u8(u, idx)),
        (native.resize_bicubic(u[idx] / np.float32(255), 24, 40),
         jnative.resize_bicubic(u[idx] / np.float32(255), 24, 40)),
        (native.flip_horizontal(u[idx].copy(), flags),
         jnative.flip_horizontal(u[idx].copy(), flags)),
        (native.flip_horizontal(f[idx].copy(), flags),
         jnative.flip_horizontal(f[idx].copy(), flags)),
    ]
    for i, (ours, theirs) in enumerate(pairs):
        assert ours.dtype == theirs.dtype, i
        np.testing.assert_array_equal(ours, theirs, err_msg=f"entry {i} ({both_paths})")


def test_native_gather_refuses_indices_out_of_range():
    if not native.available():
        pytest.skip("no native library here (g++ missing): the fallback indexes with numpy")
    imgs = np.zeros((4, 2, 2, 1), np.uint8)
    for bad in ([4], [-1]):
        with pytest.raises(IndexError, match=r"indices outside \[0, 4\)"):
            native.gather_u8(imgs, np.array(bad))


def _fresh(monkeypatch, build_dir):
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_first_call_builds_into_the_build_directory(tmp_path, monkeypatch):
    """The library is named by the hash of the source and the flags, built
    at the first call, loaded once; no temporary file is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the fallback path is tested above")
    _fresh(monkeypatch, tmp_path / "native")
    assert not (tmp_path / "native").exists()
    assert native.available()
    assert sorted(os.listdir(tmp_path / "native")) == [native.library_path().name]
    assert native.library_path().name.startswith("libdatacore-")
    assert native.build()[1] == 0.0  # built already: loaded as it is


def test_a_failed_build_takes_the_fallback(tmp_path, monkeypatch):
    """Without a compiler every entry point falls back and ``available``
    says so."""
    _fresh(monkeypatch, tmp_path / "native")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not native.available()
    imgs = np.arange(24, dtype=np.uint8).reshape(6, 2, 2, 1)
    np.testing.assert_array_equal(native.gather_normalize(imgs, np.array([5, 0])),
                                  imgs[[5, 0]].astype(np.float32) / 255.0)


def test_processes_building_at_once_share_no_temporary_file(tmp_path):
    """Four processes build into one empty directory at the same time:
    each compiles to a temporary file of its own and renames it into
    place, so all four load a whole library and one file is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    code = (
        "import sys, pathlib\n"
        "from intro_tc_vae_tpu_torch.runtime import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "import numpy as np\n"
        "ok = native.available() and native.gather_u8(np.arange(8, dtype=np.uint8)"
        ".reshape(4, 2), np.array([3]))[0, 1] == 7\n"
        "print(ok)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "native")],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o.strip() for o, _ in outs] == ["True"] * 4, outs
    assert os.listdir(tmp_path / "native") == [native.library_path().name]


def test_importing_the_port_builds_nothing(tmp_path):
    """Importing every module of the port leaves the data core unbuilt and
    unloaded (the build happens at the first call, not at collection)."""
    code = (
        "import importlib, pkgutil\n"
        "import intro_tc_vae_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from intro_tc_vae_tpu_torch.runtime import native\n"
        "print(native._tried, native._lib)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False None"
