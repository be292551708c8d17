"""Dataset fetchers: MNIST/EMNIST IDX parsing, IRIS, CIFAR-10 binaries,
LFW and TinyImageNet image folders.

Counterpart of ``deeplearning4j_tpu/datasets/fetchers.py`` (reference
``MnistManager``, ``MnistDataFetcher``, ``IrisDataFetcher``, the CIFAR,
LFW and TinyImageNet loaders), with the same data behaviour: nothing is
downloaded; the standard files are read from a local data directory
(``DL4J_TPU_DATA_DIR``, default ``~/.deeplearning4j_tpu``, the directory
the JAX package reads), and without them each fetcher builds the JAX
package's deterministic synthetic stand-in (shape- and dtype-faithful,
class-structured, the same numpy draws from the same seed, so the same
arrays bit for bit), with a loud warning and ``is_synthetic`` set. Host
numpy throughout: the fit loops move batches to the device. IDX files are
parsed in Python (the JAX package's native parser gives the same arrays).
"""
from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

DATA_DIR_ENV = "DL4J_TPU_DATA_DIR"


def _warn_synthetic(name: str, where: str):
    """LOUD marker: nothing trained on this data supports accuracy claims.
    The produced DataSets also carry ``synthetic=True`` (see
    ``datasets/impl.py``) so downstream code can tell real from stand-in."""
    log.warning(
        "%s: no local files under %s — serving DETERMINISTIC SYNTHETIC "
        "stand-in data (shape/dtype-faithful gaussian-blob classes). "
        "Results are NOT comparable to the real dataset; drop the real "
        "files into the data dir to use them.", name, where)


def data_dir() -> str:
    return os.environ.get(DATA_DIR_ENV,
                          os.path.join(os.path.expanduser("~"),
                                       ".deeplearning4j_tpu"))


# ------------------------------------------------------------------ IDX files
IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
              0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8")}


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (optionally .gz) — the MNIST container format
    (reference ``MnistManager``/``MnistDbFile``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero1, zero2, dtype_code, ndim = struct.unpack("BBBB", f.read(4))
        if zero1 != 0 or zero2 != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic)")
        if dtype_code not in IDX_DTYPES:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=IDX_DTYPES[dtype_code])
    return data.reshape(shape)


def write_idx(path: str, array: np.ndarray):
    """Inverse of :func:`read_idx` (used by tests and data preparation)."""
    codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09}
    code = codes.get(array.dtype)
    if code is None:
        raise ValueError(f"write_idx supports uint8/int8, got {array.dtype}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack("BBBB", 0, 0, code, array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(array.tobytes())


# ---------------------------------------------------------------------- MNIST
MNIST_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _find(base_dir, name) -> Optional[str]:
    for cand in (name, name + ".gz"):
        p = os.path.join(base_dir, cand)
        if os.path.exists(p):
            return p
    return None


class MnistDataFetcher:
    """Loads MNIST (or EMNIST subsets laid out the same way) as numpy arrays:
    features [n, 784] float32 in [0, 1], labels one-hot [n, 10].

    ``synthetic=True`` (or files absent + ``allow_synthetic``) generates a
    deterministic class-structured stand-in: per-class gaussian blob templates
    — classifiable, so training smoke tests show loss decreasing."""

    NUM_CLASSES = 10
    IMG = 28

    LABEL_OFFSET = 0  # EMNIST 'letters' labels are 1-indexed on disk

    def __init__(self, train: bool = True, binarize: bool = False,
                 shuffle: bool = False, seed: int = 123,
                 subdir: str = "mnist", synthetic: Optional[bool] = None,
                 num_synthetic: int = 2048):
        base = os.path.join(data_dir(), subdir)
        img_name, lbl_name = MNIST_FILES[train]
        img_path = _find(base, img_name)
        lbl_path = _find(base, lbl_name)
        have_files = img_path is not None and lbl_path is not None
        if synthetic is None:
            synthetic = not have_files
            if synthetic:
                _warn_synthetic(type(self).__name__, base)
        if synthetic:
            self.features, labels_idx = self._synthetic(seed, num_synthetic)
            self.is_synthetic = True
        else:
            imgs = read_idx(img_path).astype(np.float32) / 255.0
            self.features = imgs.reshape(imgs.shape[0], -1)
            # offset applies to on-disk labels only (synthetic are 0-indexed)
            labels_idx = read_idx(lbl_path).astype(np.int64) - self.LABEL_OFFSET
            self.is_synthetic = False
        if binarize:
            self.features = (self.features > 0.5).astype(np.float32)
        if labels_idx.min() < 0 or labels_idx.max() >= self.NUM_CLASSES:
            raise ValueError(
                f"Label ids outside [0, {self.NUM_CLASSES}) after offset "
                f"{self.LABEL_OFFSET}: range [{labels_idx.min()}, "
                f"{labels_idx.max()}] — wrong split or corrupt label file")
        self.labels = np.eye(self.NUM_CLASSES, dtype=np.float32)[labels_idx]
        if shuffle:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(self.features))
            self.features = self.features[idx]
            self.labels = self.labels[idx]

    def _synthetic(self, seed, n):
        rng = np.random.default_rng(seed)
        d = self.IMG * self.IMG
        templates = rng.random((self.NUM_CLASSES, d)).astype(np.float32)
        labels = rng.integers(0, self.NUM_CLASSES, size=n)
        noise = rng.random((n, d)).astype(np.float32)
        feats = np.clip(0.6 * templates[labels] + 0.4 * noise, 0.0, 1.0)
        return feats.astype(np.float32), labels

    def total_examples(self) -> int:
        return len(self.features)


class EmnistDataFetcher(MnistDataFetcher):
    """EMNIST (reference ``EmnistDataFetcher``): same IDX layout under an
    ``emnist-<split>`` directory; class count depends on the split."""

    SPLITS = {"balanced": 47, "byclass": 62, "bymerge": 47, "digits": 10,
              "letters": 26, "mnist": 10}

    def __init__(self, split: str = "balanced", train: bool = True, **kw):
        if split not in self.SPLITS:
            raise ValueError(f"Unknown EMNIST split '{split}' "
                             f"(known: {sorted(self.SPLITS)})")
        self.NUM_CLASSES = self.SPLITS[split]
        # the 'letters' split is 1-indexed on disk (a=1..z=26); the canonical
        # class mapping is 0-indexed, so shift rather than wrap
        self.LABEL_OFFSET = 1 if split == "letters" else 0
        super().__init__(train=train, subdir=f"emnist-{split}", **kw)


# ----------------------------------------------------------------------- IRIS
class IrisDataFetcher:
    """IRIS (reference ``IrisDataFetcher``): 150×4 features, 3 classes. Served
    from scikit-learn's bundled copy (no network needed)."""

    def __init__(self):
        from sklearn.datasets import load_iris
        data = load_iris()
        self.features = data.data.astype(np.float32)
        self.labels = np.eye(3, dtype=np.float32)[data.target]

    def total_examples(self) -> int:
        return 150


# ------------------------------------------------------------------- CIFAR-10
class CifarDataFetcher:
    """CIFAR-10 binary-format parser (reference ``CifarDataSetIterator`` uses
    DataVec's loader): ``data_batch_{1..5}.bin`` / ``test_batch.bin``, each
    record = 1 label byte + 3072 pixel bytes (RGB planes). Features returned
    NCHW [n, 3, 32, 32] float32 in [0,1]; synthetic fallback as with MNIST."""

    NUM_CLASSES = 10

    def __init__(self, train: bool = True, seed: int = 123,
                 synthetic: Optional[bool] = None, num_synthetic: int = 1024):
        base = os.path.join(data_dir(), "cifar10")
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [_find(base, n) for n in names]
        have = all(p is not None for p in paths)
        if synthetic is None:
            synthetic = not have
            if synthetic:
                _warn_synthetic(type(self).__name__, base)
        if synthetic:
            rng = np.random.default_rng(seed)
            labels = rng.integers(0, 10, size=num_synthetic)
            templates = rng.random((10, 3, 32, 32)).astype(np.float32)
            noise = rng.random((num_synthetic, 3, 32, 32)).astype(np.float32)
            self.features = np.clip(0.6 * templates[labels] + 0.4 * noise, 0, 1)
            self.is_synthetic = True
        else:
            feats, labels = [], []
            for p in paths:
                raw = np.frombuffer(open(p, "rb").read(), np.uint8)
                rec = raw.reshape(-1, 3073)
                labels.append(rec[:, 0])
                feats.append(rec[:, 1:].reshape(-1, 3, 32, 32))
            labels = np.concatenate(labels)
            self.features = (np.concatenate(feats).astype(np.float32) / 255.0)
            self.is_synthetic = False
        self.labels = np.eye(10, dtype=np.float32)[labels]

    def total_examples(self) -> int:
        return len(self.features)


# ------------------------------------------------------- image-folder datasets
class _ImageFolderFetcher:
    """Shared machinery for LFW/TinyImageNet: a directory of
    ``<class-name>/<image files>`` (jpg/png/ppm via PIL), resized to the
    dataset's canonical shape; synthetic class-blob fallback when absent.
    Features NCHW float32 in [0, 1], labels one-hot."""

    IMG = 64
    CHANNELS = 3
    DEFAULT_CLASSES = 10

    def __init__(self, subdir: str, seed: int = 123,
                 synthetic: Optional[bool] = None, num_synthetic: int = 512,
                 num_classes: Optional[int] = None,
                 image_size: Optional[int] = None):
        self.IMG = int(image_size) if image_size else self.IMG
        base = os.path.join(data_dir(), subdir)
        class_dirs = (sorted(d for d in os.listdir(base)
                             if os.path.isdir(os.path.join(base, d)))
                      if os.path.isdir(base) else [])
        if synthetic is None:
            synthetic = not class_dirs
            if synthetic:
                _warn_synthetic(type(self).__name__, base)
        if synthetic:
            self.num_classes = int(num_classes or self.DEFAULT_CLASSES)
            rng = np.random.default_rng(seed)
            shape = (self.CHANNELS, self.IMG, self.IMG)
            labels = rng.integers(0, self.num_classes, size=num_synthetic)
            templates = rng.random((self.num_classes,) + shape).astype(np.float32)
            noise = rng.random((num_synthetic,) + shape).astype(np.float32)
            self.features = np.clip(0.6 * templates[labels] + 0.4 * noise, 0, 1)
            self.class_names = [f"class_{i}" for i in range(self.num_classes)]
            self.is_synthetic = True
        else:
            from PIL import Image
            exts = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")
            feats, labels_list = [], []
            self.class_names = class_dirs
            self.num_classes = len(class_dirs)
            for ci, cname in enumerate(class_dirs):
                cdir = os.path.join(base, cname)
                # accept images directly in the class dir or one level down
                # (TinyImageNet's <wnid>/images/ layout)
                files = [os.path.join(cdir, fn)
                         for fn in sorted(os.listdir(cdir))
                         if fn.lower().endswith(exts)]
                for sub in sorted(os.listdir(cdir)):
                    subdir = os.path.join(cdir, sub)
                    if os.path.isdir(subdir):
                        files += [os.path.join(subdir, fn)
                                  for fn in sorted(os.listdir(subdir))
                                  if fn.lower().endswith(exts)]
                for path in files:
                    img = Image.open(path).convert("RGB")
                    img = img.resize((self.IMG, self.IMG))
                    arr = np.asarray(img, np.float32) / 255.0  # HWC
                    feats.append(arr.transpose(2, 0, 1))       # → CHW
                    labels_list.append(ci)
            if not feats:
                raise ValueError(
                    f"{type(self).__name__}: class directories exist under "
                    f"{base} but contain no image files ({'/'.join(exts)}) — "
                    f"expected <class>/<image> or <class>/<subdir>/<image>")
            self.features = np.stack(feats)
            labels = np.asarray(labels_list)
            self.is_synthetic = False
        self.labels = np.eye(self.num_classes, dtype=np.float32)[labels]

    def total_examples(self) -> int:
        return len(self.features)


class LFWDataFetcher(_ImageFolderFetcher):
    """Labeled Faces in the Wild (reference
    ``datasets/fetchers/LFWDataFetcher.java:1``: auto-download + per-person
    folders). Layout: ``<data_dir>/lfw/<person>/<image>.jpg``; canonical
    250×250 RGB, resized here to ``image_size`` (default 250 like the
    reference; pass 64 for fast experiments)."""

    IMG = 250
    DEFAULT_CLASSES = 5749  # people in full LFW

    def __init__(self, seed: int = 123, synthetic: Optional[bool] = None,
                 num_synthetic: int = 128, num_classes: Optional[int] = None,
                 image_size: Optional[int] = None):
        super().__init__("lfw", seed=seed, synthetic=synthetic,
                         num_synthetic=num_synthetic,
                         num_classes=num_classes or 10,
                         image_size=image_size)


class TinyImageNetFetcher(_ImageFolderFetcher):
    """Tiny ImageNet-200 (reference
    ``datasets/iterator/impl/TinyImageNetDataSetIterator.java``): 200 classes
    of 64×64 RGB. Layout: ``<data_dir>/tinyimagenet/<wnid>/<image>.jpg``."""

    IMG = 64
    DEFAULT_CLASSES = 200

    def __init__(self, seed: int = 123, synthetic: Optional[bool] = None,
                 num_synthetic: int = 512, num_classes: Optional[int] = None):
        super().__init__("tinyimagenet", seed=seed, synthetic=synthetic,
                         num_synthetic=num_synthetic,
                         num_classes=num_classes or self.DEFAULT_CLASSES)
