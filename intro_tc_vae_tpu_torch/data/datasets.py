"""Datasets: dSprites, MPI3D (+ small variants), Ukiyo-E faces, Synthetic.

Counterpart of ``intro_tc_vae_tpu/data/datasets.py`` (plain numpy and
PIL, copied because importing the JAX package imports jax): the same npz
keys, factor grids and masks, the same native gather/normalize and lazy
bicubic resize (``runtime/native.py``), the Ukiyo-E decoded-uint8 cache
and flip stream, and float32 NHWC images in [0, 1], so both packages give
the same bytes for the same indices. The loader (``data/loader.py``)
converts batches to NCHW.

The raw surface (``get_batch_raw``, ``raw_array``, ``flip_flags``) feeds
the loader's uint8 transfer and device-resident cache: a dataset offers it
only where ``raw / 255`` is its float batch bit for bit.

Ukiyo-E's labels are read with the standard ``csv`` module, so the port
does not depend on pandas, into what the JAX ``load_labels`` derives with
``pandas.read_csv`` (``_read_labels_csv``).
"""

from __future__ import annotations

import csv
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from intro_tc_vae_tpu_torch.data.image import load_image


class DisentanglementDataset:
    """ABC: a dataset whose images are generated from ground-truth factors.

    Reference: dataset.py:30-37.
    """

    @property
    def latent_indices(self) -> List[int]:
        raise NotImplementedError

    @property
    def factor_sizes(self) -> List[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        """Vectorized image gather -> float32 [B, H, W, C]."""
        return np.stack([self[i][0] for i in np.asarray(indices)], axis=0)

    def get_batch_raw(self, indices: np.ndarray):
        """Raw uint8 batch [B, H, W, C], or None when no bit-exact uint8
        path exists for this dataset. When non-None,
        ``raw.astype(float32) / 255`` equals ``get_batch(indices)`` bit for
        bit, so the loader can transfer uint8 and normalize on the device."""
        return None

    def raw_array(self):
        """Full uint8 [N, H, W, C] storage when a bit-exact uint8 path
        exists at the target size; None otherwise. The loader's
        device-resident cache holds it; augmentation is not applied here
        (the loader applies ``flip_flags`` on the device)."""
        return None

    def flip_flags(self, n: int):
        """Per-sample horizontal-flip decisions for the next n rows (uint8
        0/1), or None when this dataset does not augment. Drawn from the
        dataset's own RNG so cached and uncached paths share them."""
        return None


def factor_bases(sizes: Sequence[int]) -> np.ndarray:
    """Mixed-radix place values: bases[k] = prod(sizes)/cumprod(sizes)[k]."""
    sizes = np.asarray(sizes)
    return (np.prod(sizes) / np.cumprod(sizes)).astype(np.int64)


def index_to_factor(idx, bases, sizes) -> np.ndarray:
    """Flat dataset index -> factor tuple (mixed-radix decomposition)."""
    return np.mod(np.floor_divide(np.asarray(idx)[..., None], bases), sizes)


def get_spaced_elements(arr: np.ndarray, n: int) -> np.ndarray:
    """n evenly spaced values from the unique values of arr
    (reference dataset.py:164-176)."""
    unique_values = np.unique(arr)
    idx = np.round(np.linspace(0, len(unique_values) - 1, n)).astype(int)
    return unique_values[idx]


class _ArrayDataset(DisentanglementDataset):
    """Shared implementation for npz-array-backed factor datasets."""

    def __init__(self, imgs: np.ndarray, latents_values: np.ndarray, resize: int = 64):
        self.imgs = imgs  # uint8 [N, H, W] or [N, H, W, C]
        self.latents_values = latents_values
        self.resize = resize

    def __len__(self) -> int:
        return len(self.imgs)

    def _to_float(self, img: np.ndarray) -> np.ndarray:
        arr = img.astype(np.float32)
        if arr.max() > 1.0:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.resize != arr.shape[0]:
            from PIL import Image

            pil = Image.fromarray(np.squeeze(img))
            pil = pil.resize((self.resize, self.resize), Image.BICUBIC)
            arr = np.asarray(pil, dtype=np.float32)
            if arr.max() > 1.0:
                arr = arr / 255.0
            if arr.ndim == 2:
                arr = arr[:, :, None]
        return arr

    def __getitem__(self, index: int):
        return self._to_float(self.imgs[index]), self.latents_values[index]

    def _raw_at_target_size(self) -> bool:
        """Stored uint8 at the target size: /255 is the only transform
        between storage and output, and it moves to the device exactly."""
        return self.imgs.dtype == np.uint8 and self.resize == self.imgs.shape[1]

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        from intro_tc_vae_tpu_torch.runtime import gather, gather_normalize, resize_bicubic

        indices = np.asarray(indices)
        if self.imgs.dtype == np.uint8:
            arr = gather_normalize(self.imgs, indices)  # native parallel gather
        else:
            arr = gather(self.imgs.astype(np.float32, copy=False), indices)
            if arr.max() > 1.0:
                arr = arr / 255.0
        if arr.ndim == 3:
            arr = arr[..., None]
        if self.resize != arr.shape[1]:
            arr = resize_bicubic(arr, self.resize, self.resize)
        return arr

    def get_batch_raw(self, indices: np.ndarray):
        if not self._raw_at_target_size():
            return None
        from intro_tc_vae_tpu_torch.runtime import gather_u8

        arr = gather_u8(self.imgs, np.asarray(indices))
        return arr[..., None] if arr.ndim == 3 else arr

    def raw_array(self):
        if not self._raw_at_target_size():
            return None
        return self.imgs if self.imgs.ndim == 4 else self.imgs[..., None]


class DSprites(_ArrayDataset):
    """dSprites (64x64 binary sprites; factors [1,3,6,40,32,32]).

    Reference: dataset.py:131-162. Loads
    dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz from ``data_root``.
    """

    def __init__(self, arr, resize: int = 64):
        imgs = arr["imgs"] * np.uint8(255)
        super().__init__(imgs, arr["latents_values"], resize)

    @property
    def latent_indices(self) -> List[int]:
        return [1, 2, 3, 4, 5]

    @property
    def factor_sizes(self) -> List[int]:
        return [1, 3, 6, 40, 32, 32]

    @classmethod
    def load_data(cls, resize: int = 64, data_root: str | None = None):
        data_root = data_root or os.path.expanduser("~/dsprites-dataset")
        arr = np.load(
            os.path.join(data_root, "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz")
        )
        return cls(arr, resize=resize)


class DSpritesSmall(DSprites):
    """dSprites subsampled to factors [1,3,6,4,10,10]
    (reference dataset.py:178-201)."""

    def __init__(self, arr, resize: int = 64):
        lv = arr["latents_values"]
        rotation_mask = np.isin(lv[:, 3], get_spaced_elements(lv[:, 3], 5)[:-1])
        x_mask = np.isin(lv[:, 4], get_spaced_elements(lv[:, 4], 10))
        y_mask = np.isin(lv[:, 5], get_spaced_elements(lv[:, 5], 10))
        mask = rotation_mask & x_mask & y_mask
        if mask.sum() != np.prod(self.factor_sizes):
            raise ValueError(f"the factor masks keep {mask.sum()} rows, expected "
                             f"{np.prod(self.factor_sizes)}: not the dSprites factor grid")
        _ArrayDataset.__init__(
            self, arr["imgs"][mask] * np.uint8(255), lv[mask], resize
        )

    @property
    def factor_sizes(self) -> List[int]:
        return [1, 3, 6, 4, 10, 10]


class MPI3D(_ArrayDataset):
    """MPI3D-toy (64x64 RGB; factors [6,6,2,3,3,40,40]).

    Reference: dataset.py:40-89, with __len__ defined (the reference omits
    it, quirk Q5).
    """

    def __init__(self, arr, resize: int = 64):
        imgs = arr["images"]
        bases = factor_bases(self.orig_factor_sizes)
        latents = index_to_factor(
            np.arange(imgs.shape[0]), bases, self.orig_factor_sizes
        )
        super().__init__(imgs, latents, resize)

    @property
    def latent_indices(self) -> List[int]:
        return [0, 1, 2, 3, 4, 5, 6]

    @property
    def factor_sizes(self) -> List[int]:
        return [6, 6, 2, 3, 3, 40, 40]

    @property
    def orig_factor_sizes(self) -> List[int]:
        return [6, 6, 2, 3, 3, 40, 40]

    @classmethod
    def load_data(cls, resize: int = 64, data_root: str | None = None):
        data_root = data_root or os.path.expanduser("~/mpi3d-dataset")
        arr = np.load(os.path.join(data_root, "mpi3d_toy.npz"))
        return cls(arr, resize=resize)


class MPI3DSmall(MPI3D):
    """MPI3D with camera angles subsampled 40 -> 4 per axis
    (reference dataset.py:92-129)."""

    def __init__(self, arr, resize: int = 64):
        imgs = arr["images"]
        bases = factor_bases(self.orig_factor_sizes)
        latents = index_to_factor(
            np.arange(imgs.shape[0]), bases, self.orig_factor_sizes
        )
        h_mask = np.isin(latents[:, 5], get_spaced_elements(latents[:, 5], 4))
        v_mask = np.isin(latents[:, 6], get_spaced_elements(latents[:, 6], 4))
        mask = h_mask & v_mask
        if mask.sum() != np.prod(self.factor_sizes):
            raise ValueError(f"the camera masks keep {mask.sum()} rows, expected "
                             f"{np.prod(self.factor_sizes)}: not the MPI3D factor grid")
        _ArrayDataset.__init__(self, imgs[mask], latents[mask], resize)

    @property
    def factor_sizes(self) -> List[int]:
        return [6, 6, 2, 3, 3, 4, 4]


# The strings pandas.read_csv reads as a missing value by default
# (pandas._libs.parsers.STR_NA_VALUES)
_CSV_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _read_labels_csv(path: str, names: Sequence[str]) -> dict:
    """The columns of a CSV as lists, its first ``len(names)`` columns
    renamed to ``names`` by position; a missing value (an empty cell, or one
    of pandas' NA strings) is float NaN and blank lines are skipped, as
    ``pandas.read_csv`` reads them. Values stay strings otherwise."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    header = list(rows[0])
    header[: len(names)] = list(names)[: len(header)]
    columns = {name: [] for name in header}
    for row in rows[1:]:
        row = row + [""] * (len(header) - len(row))
        for name, value in zip(header, row):
            columns[name].append(math.nan if value in _CSV_NA else value)
    return columns


def _as_str_column(values: Sequence) -> list:
    """``Series.astype(str)`` of a column as pandas 3 reads it: a column
    of numbers only is numeric to pandas (int64, or float64 once a value
    is missing or fractional), and its values print as such (``1``,
    ``1850.0``); a missing value stays missing."""
    present = [v for v in values if not _missing(v)]

    def parses(kind) -> bool:
        try:
            for v in present:
                kind(v)
        except ValueError:
            return False
        return bool(present)

    if parses(int) and len(present) == len(values):
        return [str(int(v)) for v in values]
    if parses(float):
        return [v if _missing(v) else str(float(v)) for v in values]
    return list(values)


def _categorical_codes(values: Sequence) -> Tuple[list, list]:
    """(categories, codes) as ``pandas.Series.astype("category")`` gives
    them: the sorted distinct non-missing values, and each value's index
    among them (-1 for a missing one)."""
    categories = sorted({v for v in values if not _missing(v)})
    where = {c: i for i, c in enumerate(categories)}
    return categories, [-1 if _missing(v) else where[v] for v in values]


def _missing(value) -> bool:
    return isinstance(value, float) and math.isnan(value)


class UkiyoE:
    """ARC Ukiyo-E face crops, labeled by painter: a plain labeled dataset,
    not factor-structured (reference dataset.py:207-288).

    ``labels`` is what ``load_labels`` returns: a mapping from column name
    to the column's values. Entries come from the ``singleface_filename``
    column when present, else ``filename``; entries whose file is missing
    are dropped. Each entry is (filename, code of its ``category`` value).
    Horizontal flips (p = 0.5) are drawn once per batch in the calling
    thread from the dataset's own ``RandomState``.
    """

    COLUMN_NAMES = [
        "ACNo.", "Print title", "Picture name", "Official title", "Text",
        "Publisher", "Format", "Direction", "Seal", "Painter",
        "revised seals", "Year in A.D.", "Year in Japanese Calender",
        "Region", "Theater", "Title of play", "Reading of Title of play",
        "Performed title", "Reading of Performed title",
        "Main performed title", "Classification title", "Library", "Text2",
        "homeURL", "SmallImageURL", "LargeImageURL", "filename",
    ]

    def __init__(self, root: str, labels, category: str = "Painter", resize: int = 256,
                 cache: bool = True, decode_workers: int | None = None):
        self.root = root
        self.category = category
        self.categories, self.codes = _categorical_codes(list(labels[category]))
        self.resize = resize
        self.random_flip = True
        self._rng = np.random.RandomState()  # unseeded, as in the JAX package
        # One-time decoded-uint8 cache of the final PIL stage: JPEG decode
        # bounds the uncached path; the stage is uint8 before the /255, so
        # the cache is exact
        self.cache = cache
        self.decode_workers = decode_workers or min(32, os.cpu_count() or 4)
        self._cache_arr: np.ndarray | None = None

        name_col = "singleface_filename" if "singleface_filename" in labels else "filename"
        self.entries = [
            (name, code)
            for name, code in zip(labels[name_col], self.codes)
            if os.path.exists(os.path.join(self.root, str(name)))
        ]

    def __len__(self) -> int:
        return len(self.entries)

    def _decode_final(self, index: int) -> np.ndarray:
        """Decode one entry through the load_image pipeline (decode -> RGB
        -> BICUBIC 256 -> BICUBIC resize) and keep its final uint8 stage."""
        from PIL import Image

        path = os.path.join(self.root, self.entries[index][0])
        img = Image.open(path)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img = img.resize((256, 256), Image.BICUBIC)
        img = img.resize((self.resize, self.resize), Image.BICUBIC)
        return np.asarray(img, dtype=np.uint8)

    def _ensure_cache(self) -> np.ndarray:
        if self._cache_arr is None:
            from concurrent.futures import ThreadPoolExecutor

            n = len(self.entries)
            arr = np.empty((n, self.resize, self.resize, 3), np.uint8)
            with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
                for i, img in enumerate(pool.map(self._decode_final, range(n))):
                    arr[i] = img
            self._cache_arr = arr
        return self._cache_arr

    def __getitem__(self, index: int):
        image_filename, label = self.entries[index]
        if self._cache_arr is not None:
            img = self.get_batch(np.array([index]))[0]
            return img, np.array(label)
        img = load_image(
            os.path.join(self.root, image_filename),
            input_height=256,
            output_height=self.resize,
            is_mirror=False,
            is_random_crop=False,
        )
        if self.random_flip and self._rng.rand() < 0.5:
            img = img[:, ::-1, :].copy()
        return img, np.array(label)

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        from intro_tc_vae_tpu_torch.runtime import flip_horizontal, gather_normalize

        indices = np.asarray(indices)
        if self.cache:
            arr = gather_normalize(self._ensure_cache(), indices)
            flags = self.flip_flags(len(indices))
            if flags is not None:
                arr = flip_horizontal(arr, flags)
            return arr
        # uncached: per-image decode on a thread pool; the flags are drawn
        # first, in the calling thread (RandomState is not thread-safe)
        from concurrent.futures import ThreadPoolExecutor

        flags = self.flip_flags(len(indices))

        def decode(i):
            return load_image(
                os.path.join(self.root, self.entries[int(i)][0]),
                input_height=256,
                output_height=self.resize,
                is_mirror=False,
                is_random_crop=False,
            )

        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            imgs = np.stack(list(pool.map(decode, indices)), axis=0)
        if flags is not None:
            imgs = flip_horizontal(np.ascontiguousarray(imgs, np.float32), flags)
        return imgs

    def get_batch_raw(self, indices: np.ndarray):
        """uint8 gather + flip from the decoded cache (None uncached)."""
        if not self.cache:
            return None
        from intro_tc_vae_tpu_torch.runtime import flip_horizontal, gather_u8

        indices = np.asarray(indices)
        arr = gather_u8(self._ensure_cache(), indices)
        flags = self.flip_flags(len(indices))
        if flags is not None:
            arr = flip_horizontal(arr, flags)
        return arr

    def raw_array(self):
        """The decoded-uint8 cache; the consumer applies ``flip_flags``."""
        return self._ensure_cache() if self.cache else None

    def flip_flags(self, n: int):
        if not self.random_flip:
            return None
        return (self._rng.rand(n) < 0.5).astype(np.uint8)

    def get_label(self, index: int) -> str:
        """The category value of row ``index`` of the label table (as in
        the JAX package, a row of the table, not an entry)."""
        return self.categories[self.codes[index]]

    @classmethod
    def load_data(cls, resize: int = 256, data_root: str | None = None,
                  cache: bool = True):
        data_root = data_root or os.path.expanduser("~/arc-ukiyoe-faces/scratch")
        image_dir = os.path.join(data_root, "arc_extracted_face_images")
        return cls(image_dir, cls.load_labels(data_root), "Painter",
                   resize=resize, cache=cache)

    @classmethod
    def load_labels(cls, data_root: str) -> dict:
        """The label table the JAX ``load_labels`` builds with pandas:
        the kept columns (``Painter``, ``Year in A.D.``, ``Region``,
        ``filename``, and ``singleface_filename`` when present) as lists,
        ``Painter`` converted as ``astype(str)`` converts it
        (``_as_str_column``; with pandas 3, which the tests run the JAX
        package with, a missing painter stays missing and takes code -1)."""
        table = _read_labels_csv(
            os.path.join(data_root, "arc_extracted_face_metadata.csv"), cls.COLUMN_NAMES)
        keep = ["Painter", "Year in A.D.", "Region", "filename"]
        if "singleface_filename" in table:
            keep.append("singleface_filename")
        labels = {k: table[k] for k in keep}
        labels["Painter"] = _as_str_column(labels["Painter"])
        return labels


class Synthetic(DisentanglementDataset):
    """Procedural disentanglement dataset (no files needed).

    Factors (color, scale, x, y) render a filled square on a black
    background; images are generated vectorized per batch. It has no raw
    uint8 path (its values are no multiples of 1/255).
    """

    def __init__(
        self,
        image_size: int = 64,
        cdim: int = 3,
        sizes: Sequence[int] = (4, 5, 8, 8),
    ):
        self._factor_sizes = list(sizes)
        self.image_size = image_size
        self.cdim = cdim
        self._bases = factor_bases(self._factor_sizes)
        n = int(np.prod(self._factor_sizes))
        self.latents_values = index_to_factor(
            np.arange(n), self._bases, self._factor_sizes
        )

    @property
    def latent_indices(self) -> List[int]:
        return list(range(len(self._factor_sizes)))

    @property
    def factor_sizes(self) -> List[int]:
        return self._factor_sizes

    def __len__(self) -> int:
        return int(np.prod(self._factor_sizes))

    def _render(self, factors: np.ndarray) -> np.ndarray:
        """Vectorized render: factors [B, 4] -> images [B, S, S, C]."""
        s = self.image_size
        n_color, n_scale, n_x, n_y = self._factor_sizes
        color, scale, fx, fy = (factors[:, i] for i in range(4))
        side = ((scale + 1) * s) // (2 * n_scale)  # [s/2n .. s/2]
        x0 = (fx * (s - side)) // max(n_x - 1, 1)
        y0 = (fy * (s - side)) // max(n_y - 1, 1)
        xs = np.arange(s)[None, :]
        col_mask = (xs >= x0[:, None]) & (xs < (x0 + side)[:, None])  # [B, S]
        row_mask = (xs >= y0[:, None]) & (xs < (y0 + side)[:, None])
        mask = row_mask[:, :, None] & col_mask[:, None, :]  # [B, S, S]
        img = mask.astype(np.float32)[..., None]
        intensity = 0.25 + 0.75 * (color[:, None, None, None] / max(n_color - 1, 1))
        if self.cdim == 3:
            chans = [
                img * intensity,
                img * (1.0 - 0.5 * intensity),
                img * np.abs(1.0 - 2.0 * intensity * 0.5),
            ]
            return np.concatenate(chans, axis=-1).astype(np.float32)
        return (img * intensity).astype(np.float32)

    def __getitem__(self, index: int):
        factors = self.latents_values[index : index + 1]
        return self._render(factors)[0], self.latents_values[index]

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        return self._render(self.latents_values[np.asarray(indices)])


# name -> (image_size, channels, cdim); the table of reference
# train.py:56-92 plus 'synthetic*', as in the JAX package
_TABLE = {
    "ukiyo_e256": (256, [64, 128, 256, 512, 512, 512], 3),
    "ukiyo_e128": (128, [64, 128, 256, 512, 512], 3),
    "ukiyo_e64": (64, [64, 128, 256, 512], 3),
    "dsprites": (64, [64, 128, 256, 512], 1),
    "dsprites_small": (64, [64, 128, 256, 512], 1),
    "mpi3d": (64, [64, 128, 256, 512], 3),
    "mpi3d_small": (64, [64, 128, 256, 512], 3),
    "synthetic": (64, [64, 128, 256, 512], 3),
    "synthetic128": (128, [64, 128, 256, 512, 512], 3),
    "synthetic256": (256, [64, 128, 256, 512, 512, 512], 3),
    "synthetic_small": (32, [16, 32], 3),  # tiny: smoke tests / demos
}


def load_dataset(
    name: str, data_root: str | None = None
) -> Tuple[DisentanglementDataset, int, List[int], int]:
    """Dataset factory: name -> (dataset, image_size, channels, cdim).
    ``data_root`` is the directory of the dataset's files (each dataset
    has its own default under the home directory, as in the JAX package)."""
    if name not in _TABLE:
        raise NotImplementedError(f"dataset '{name}' is not supported")
    image_size, channels, cdim = _TABLE[name]

    if name.startswith("ukiyo_e"):
        ds = UkiyoE.load_data(resize=image_size, data_root=data_root)
    elif name == "dsprites":
        ds = DSprites.load_data(data_root=data_root)
    elif name == "dsprites_small":
        ds = DSpritesSmall.load_data(data_root=data_root)
    elif name == "mpi3d":
        ds = MPI3D.load_data(data_root=data_root)
    elif name == "mpi3d_small":
        ds = MPI3DSmall.load_data(data_root=data_root)
    elif name == "synthetic_small":
        ds = Synthetic(image_size=image_size, cdim=cdim, sizes=(2, 2, 4, 4))
    else:
        ds = Synthetic(image_size=image_size, cdim=cdim)
    return ds, image_size, channels, cdim
