"""PyTorch port, the datasets (``intro_tc_vae_tpu_torch/data/datasets.py``,
``data/image.py``) against the JAX package's: the same indices give the
same bytes.

dSprites and MPI3D on npz files in the real layout (the keys, dtypes and
full factor grids of the published archives), with small stored images,
as tests/test_real_corpus_schema.py builds them; Ukiyo-E on the fixture in
tests/test_data (5 images on disk, the row naming missing.jpg dropped),
cached and uncached, both packages' flips drawn from the same injected
``RandomState``. Where a dataset resizes (the stored images are smaller
than the target), both packages run the same resize path: native where
both libraries load, else their fallbacks (tests/test_torch_native.py).

The Ukiyo-E labels are read without pandas in the port; they are held to
what the JAX package's ``load_labels`` (pandas) derives: the codes, the
entries and the labels of each entry.
"""

import os

import numpy as np
import pytest

from intro_tc_vae_tpu.data import datasets as jdatasets
from intro_tc_vae_tpu.data.image import load_image as jload_image
from intro_tc_vae_tpu.runtime import native as jnative
from intro_tc_vae_tpu_torch.data import datasets, load_image
from intro_tc_vae_tpu_torch.runtime import native

DATA_DIR = os.path.join(os.path.dirname(__file__), "test_data")
IMAGE_DIR = os.path.join(DATA_DIR, "arc_extracted_face_images")
DSPRITES_FACTORS = [1, 3, 6, 40, 32, 32]
DSPRITES_NPZ = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"
MPI3D_FACTORS = [6, 6, 2, 3, 3, 40, 40]


@pytest.fixture
def same_path(monkeypatch):
    """Both packages' data cores on one path: native where both libraries
    load in this process, else both on their numpy/PIL fallbacks. Returns
    the path's name, checked against both packages' ``available()``.

    The two libraries load independently: the JAX package builds its own
    into one shared temporary file, so test workers that build at once can
    leave it unloaded in one process while the port's loads; a resize
    (native float bicubic, or PIL through uint8) then differs between
    the packages."""
    if not (native.available() and jnative.available()):
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    path = "native" if native.available() else "fallback"
    assert_path(path)
    return path


def assert_path(path):
    """Both packages' data cores are on ``path``."""
    assert (native.available(), jnative.available()) == (path == "native",) * 2


def _dsprites_latents_values() -> np.ndarray:
    grids = [np.array([1.0]), np.arange(1, 4, dtype=np.float64), np.linspace(0.5, 1.0, 6),
             np.linspace(0.0, 2.0 * np.pi, 40), np.linspace(0.0, 1.0, 32),
             np.linspace(0.0, 1.0, 32)]
    mesh = np.meshgrid(*grids, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1)


@pytest.fixture(scope="module")
def dsprites_root(tmp_path_factory):
    """0/1 sprites on the full grid, stored 8x8 (the real archive: 64x64)."""
    root = tmp_path_factory.mktemp("dsprites-dataset")
    n = int(np.prod(DSPRITES_FACTORS))
    imgs = (np.random.RandomState(0).rand(n, 8, 8) < 0.2).astype(np.uint8)
    np.savez(os.path.join(root, DSPRITES_NPZ), imgs=imgs,
             latents_values=_dsprites_latents_values())
    return str(root)


@pytest.fixture(scope="module")
def mpi3d_root(tmp_path_factory):
    """uint8 RGB on the full grid, stored 4x4 (the real archive: 64x64)."""
    root = tmp_path_factory.mktemp("mpi3d-dataset")
    n = int(np.prod(MPI3D_FACTORS))
    images = np.random.RandomState(1).randint(0, 256, size=(n, 4, 4, 3), dtype=np.uint8)
    np.savez(os.path.join(root, "mpi3d_toy.npz"), images=images)
    return str(root)


ARRAY_SETS = {"dsprites": (737280, 1), "dsprites_small": (7200, 1),
              "mpi3d": (1036800, 3), "mpi3d_small": (10368, 3)}


@pytest.mark.parametrize("name", sorted(ARRAY_SETS))
def test_array_datasets_equal_jax(name, dsprites_root, mpi3d_root, same_path):
    """load_dataset(name): length, factors, latents, and the batches and
    items of both packages bit-equal (the lazy resize to 64 included); no
    raw path, since the stored images are not at the target size."""
    root = dsprites_root if name.startswith("dsprites") else mpi3d_root
    ours, size, channels, cdim = datasets.load_dataset(name, data_root=root)
    theirs, *jrest = jdatasets.load_dataset(name, data_root=root)
    assert [size, channels, cdim] == jrest
    assert (len(ours), cdim) == (len(theirs), ARRAY_SETS[name][1]) == ARRAY_SETS[name]
    assert ours.factor_sizes == theirs.factor_sizes
    assert ours.latent_indices == theirs.latent_indices
    np.testing.assert_array_equal(ours.latents_values, theirs.latents_values)
    idx = np.random.RandomState(4).randint(0, len(ours), size=16)
    got = ours.get_batch(idx)
    assert got.shape == (16, 64, 64, cdim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, theirs.get_batch(idx))
    for i in idx[:3]:
        (a, la), (b, lb) = ours[int(i)], theirs[int(i)]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert ours.get_batch_raw(idx) is None and ours.raw_array() is None
    assert_path(same_path)  # the comparison ran on one resize path


def test_small_variants_refuse_a_partial_grid(dsprites_root):
    arr = dict(np.load(os.path.join(dsprites_root, DSPRITES_NPZ)))
    arr = {k: v[:5000] for k, v in arr.items()}
    with pytest.raises(ValueError, match="not the dSprites factor grid"):
        datasets.DSpritesSmall(arr)


@pytest.mark.parametrize("cls", ["DSprites", "MPI3D"])
def test_raw_path_at_the_stored_size_equals_jax(cls, dsprites_root, mpi3d_root, same_path):
    """Targeted at the stored size, the array datasets offer their uint8
    storage: raw batches and the raw array equal JAX's, and raw / 255 is
    the float batch bit for bit."""
    if cls == "DSprites":
        arr, size = np.load(os.path.join(dsprites_root, DSPRITES_NPZ)), 8
    else:
        arr, size = np.load(os.path.join(mpi3d_root, "mpi3d_toy.npz")), 4
    ours = getattr(datasets, cls)(arr, resize=size)
    theirs = getattr(jdatasets, cls)(arr, resize=size)
    idx = np.random.RandomState(5).randint(0, len(ours), size=32)
    raw = ours.get_batch_raw(idx)
    assert raw.dtype == np.uint8 and raw.ndim == 4
    np.testing.assert_array_equal(raw, theirs.get_batch_raw(idx))
    np.testing.assert_array_equal(raw.astype(np.float32) / 255, ours.get_batch(idx))
    np.testing.assert_array_equal(ours.raw_array(), theirs.raw_array())
    assert ours.flip_flags(4) is None


def test_get_spaced_elements_equals_jax():
    arr = np.random.RandomState(0).randint(0, 50, size=400).astype(np.float64)
    for n in (1, 4, 10, 30):
        np.testing.assert_array_equal(datasets.get_spaced_elements(arr, n),
                                      jdatasets.get_spaced_elements(arr, n))


def test_synthetic_is_a_dataset_without_raw_path():
    ds = datasets.Synthetic(image_size=32, sizes=(2, 2, 4, 4))
    assert isinstance(ds, datasets.DisentanglementDataset)
    assert ds.get_batch_raw(np.arange(4)) is None and ds.raw_array() is None
    assert ds.flip_flags(4) is None


def test_load_dataset_routes_every_name(dsprites_root, mpi3d_root):
    kinds = {"ukiyo_e256": datasets.UkiyoE, "ukiyo_e128": datasets.UkiyoE,
             "ukiyo_e64": datasets.UkiyoE, "dsprites": datasets.DSprites,
             "dsprites_small": datasets.DSpritesSmall, "mpi3d": datasets.MPI3D,
             "mpi3d_small": datasets.MPI3DSmall, "synthetic": datasets.Synthetic,
             "synthetic128": datasets.Synthetic, "synthetic256": datasets.Synthetic,
             "synthetic_small": datasets.Synthetic}
    roots = {"ukiyo": DATA_DIR, "dspri": dsprites_root, "mpi3d": mpi3d_root}
    for name, kind in kinds.items():
        root = roots.get(name[:5])
        ds, size, channels, cdim = datasets.load_dataset(name, data_root=root)
        _, jsize, jchannels, jcdim = jdatasets.load_dataset(name, data_root=root)
        assert type(ds) is kind, name
        assert (size, channels, cdim) == (jsize, jchannels, jcdim), name
    with pytest.raises(NotImplementedError, match="'imagenet' is not supported"):
        datasets.load_dataset("imagenet")


# ---------------------------------------------------------------------------
# Ukiyo-E
# ---------------------------------------------------------------------------

def _ukiyo_pair(resize=64, cache=True, labels_root=DATA_DIR, image_dir=IMAGE_DIR, seed=7):
    ours = datasets.UkiyoE(image_dir, datasets.UkiyoE.load_labels(labels_root), "Painter",
                           resize=resize, cache=cache)
    theirs = jdatasets.UkiyoE(image_dir, jdatasets.UkiyoE.load_labels(labels_root),
                              "Painter", resize=resize, cache=cache)
    ours._rng = np.random.RandomState(seed)
    theirs._rng = np.random.RandomState(seed)
    return ours, theirs


def _entries(ds):
    return [(name, int(code)) for name, code in ds.entries]


def test_ukiyo_labels_equal_jax_on_the_fixture():
    ours, theirs = _ukiyo_pair()
    assert len(ours) == len(theirs) == 5  # missing.jpg dropped
    assert _entries(ours) == _entries(theirs)
    assert ours.categories == list(theirs.labels.cat.categories)
    assert ours.codes == [int(c) for c in theirs.labels.cat.codes]
    for i in range(6):
        assert ours.get_label(i) == theirs.get_label(i)
    labels = datasets.UkiyoE.load_labels(DATA_DIR)
    jlabels = jdatasets.UkiyoE.load_labels(DATA_DIR)
    assert list(labels) == list(jlabels.columns)
    for col in labels:
        assert [str(v) for v in labels[col]] == [str(v) for v in jlabels[col]], col


CSV_CASES = {
    # an empty painter, a quoted comma, a pandas NA string, a blank line
    "painters": ("filename", [
        ("00000001.jpg", "Kunisada"), ("00000002.jpg", ""), ("00000003.jpg", '"Hiro, Jr"'),
        ("00000004.jpg", "None"), ("", "Toyokuni"), ("00000005.jpg", "Kunisada")],
        True),
    # singleface_filename preferred over filename; an entry missing on disk
    "singleface": ("singleface_filename", [
        ("00000005.jpg", "B"), ("nothere.jpg", "A"), ("00000001.jpg", "A")], False),
    # a painter column of numbers only: numeric to pandas
    "numeric": ("filename", [("00000001.jpg", "12"), ("00000002.jpg", "3")], False),
    "numeric_with_missing": ("filename", [("00000001.jpg", "12"), ("00000002.jpg", "")],
                             False),
    "all_missing": ("filename", [("00000001.jpg", ""), ("00000002.jpg", "")], False),
}


def _write_csv(root, name_col, rows, blank_line):
    header = list(datasets.UkiyoE.COLUMN_NAMES)
    header[9] = "painter_col"  # renamed by position, as the fixture's
    if name_col == "singleface_filename":
        header.append(name_col)
    lines = [",".join(header)]
    for k, (fname, painter) in enumerate(rows):
        cells = [f"arcFX{k:04d}"] + [""] * 26
        cells[9], cells[11], cells[13] = painter, "1850", "Edo"
        cells[26] = "ignored.jpg" if name_col == "singleface_filename" else fname
        if name_col == "singleface_filename":
            cells.append(fname)
        lines.append(",".join(cells))
        if blank_line and k == 1:
            lines.append("")
    with open(os.path.join(root, "arc_extracted_face_metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_ukiyo_labels_without_pandas_equal_jax(tmp_path, case):
    name_col, rows, blank_line = CSV_CASES[case]
    _write_csv(tmp_path, name_col, rows, blank_line)
    ours, theirs = _ukiyo_pair(labels_root=str(tmp_path))
    assert _entries(ours) == _entries(theirs)
    assert len(ours) == sum(os.path.exists(os.path.join(IMAGE_DIR, f)) and f != ""
                            for f, _ in rows)
    assert ours.categories == list(theirs.labels.cat.categories)
    assert ours.codes == [int(c) for c in theirs.labels.cat.codes]


@pytest.mark.parametrize("resize", [64, 128])
@pytest.mark.parametrize("cache", [True, False], ids=["cached", "uncached"])
def test_ukiyo_batches_equal_jax(cache, resize):
    """get_batch three times (the flips drawn per batch from the injected
    RNG), items, and the raw path (cached only) of both packages."""
    ours, theirs = _ukiyo_pair(resize=resize, cache=cache)
    for idx in ([0, 2, 4, 1], [3, 3, 0, 4], [1, 0]):
        got = ours.get_batch(np.array(idx))
        assert got.shape == (len(idx), resize, resize, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, theirs.get_batch(np.array(idx)))
    for i in (0, 4):
        (a, la), (b, lb) = ours[i], theirs[i]
        np.testing.assert_array_equal(a, b)
        assert int(la) == int(lb)
    raw = ours.get_batch_raw(np.array([4, 1, 2]))
    if cache:
        np.testing.assert_array_equal(raw, theirs.get_batch_raw(np.array([4, 1, 2])))
        np.testing.assert_array_equal(ours.raw_array(), theirs.raw_array())
    else:
        assert raw is None and ours.raw_array() is None
    np.testing.assert_array_equal(ours.flip_flags(9), theirs.flip_flags(9))


def test_ukiyo_cached_equals_uncached_and_raw():
    """The cache keeps PIL's final uint8 stage: cached, uncached and raw / 255
    are the same batch, flips included (same flag stream)."""
    cached, _ = _ukiyo_pair(cache=True, seed=3)
    plain, _ = _ukiyo_pair(cache=False, seed=3)
    raw, _ = _ukiyo_pair(cache=True, seed=3)
    idx = np.array([0, 2, 4, 1, 3])
    for _ in range(3):
        a, b = cached.get_batch(idx), plain.get_batch(idx)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(raw.get_batch_raw(idx).astype(np.float32) / 255, a)


def test_ukiyo_flip_stream_is_drawn_per_batch():
    ds, _ = _ukiyo_pair(seed=0)
    batches = [ds.get_batch(np.array([0, 1, 2, 3])) for _ in range(8)]
    assert any(not np.array_equal(batches[0], b) for b in batches[1:])
    ds.random_flip = False
    assert ds.flip_flags(4) is None


@pytest.mark.parametrize("kwargs", [
    dict(input_height=256, output_height=64, is_mirror=False, is_random_crop=False),
    dict(input_height=None, output_height=48, output_width=40, is_mirror=True),
    dict(input_height=128, output_height=64, crop_height=96, is_random_crop=True),
    dict(input_height=128, output_height=64, crop_height=100, is_random_crop=False,
         is_gray=True),
], ids=["plain", "mirror", "random_crop", "center_crop_gray"])
def test_load_image_equals_jax(kwargs):
    path = os.path.join(IMAGE_DIR, "00000003.jpg")
    for seed in range(3):
        ours = load_image(path, rng=np.random.RandomState(seed), **kwargs)
        theirs = jload_image(path, rng=np.random.RandomState(seed), **kwargs)
        assert ours.dtype == np.float32 and ours.ndim == 3
        np.testing.assert_array_equal(ours, theirs)
