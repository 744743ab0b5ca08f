"""Real-dataset loaders: MorphoMNIST, Pendulum, CausalCircuit, image folders.

The port's own copy of ``causaldiffae_tpu/data/loaders.py:44-239,276-309``
(numpy; the same decoding, scaling and order): each loader materializes the
whole dataset once, and an infinite shuffled batch iterator yields
``{'image': [B,H,W,C] float32, 'y': [B], 'c': [B,n]}`` dicts, NHWC as the
JAX package feeds them (the model goes NCHW inside).

- MorphoMNIST: idx.gz images/labels + morphometrics CSV; images scaled /255;
  c = normalized [thickness, intensity].
- Pendulum: 96x96 RGBA PNGs named ``*_angle_light_len_pos.png``, labels
  parsed from the filename and normalized by the dataset's scales.
- CausalCircuit: ``train-{0..4}.npz`` / ``test.npz`` with PNG-encoded imgs
  and latents permuted [3,2,1,0] -> [arm, blue, green, red], resized to 128;
  ``simplified`` keeps the three filtered regimes of both frames.
- Generic folder loader: BOX halving + BICUBIC resize + center crop, scaled
  to [-1,1].

The port trains in one process, so nothing is sharded across processes.

PIL and pandas are imported where a loader needs them. The JAX package's
native C++ prefetch loader is not ported; ``load_data`` serves the numpy
``batch_iterator``.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import struct
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

from ..config import DATA_SCALES

__all__ = ["load_idx", "save_idx", "load_morphomnist", "load_pendulum",
           "load_circuit", "load_image_folder", "batch_iterator", "load_data", "load_split"]


# --------------------------------------------------------------------- #
# IDX (MNIST archive) codec
# --------------------------------------------------------------------- #
_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def load_idx(path: str) -> np.ndarray:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, dtype_code, ndim = struct.unpack("HBB", f.read(4))
        if zeros != 0 or dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: invalid IDX magic")
        dtype = _IDX_DTYPES[dtype_code]
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
    return data.reshape(shape)


def save_idx(arr: np.ndarray, path: str) -> None:
    code = {v: k for k, v in _IDX_DTYPES.items()}[arr.dtype.type]
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack("HBB", 0, code, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(np.ascontiguousarray(arr, dtype=np.dtype(arr.dtype).newbyteorder(">")).tobytes())


# --------------------------------------------------------------------- #
def load_morphomnist(root: str, train: bool = True,
                     columns=("thickness", "intensity")) -> Dict[str, np.ndarray]:
    prefix = "train" if train else "t10k"
    images = load_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte.gz"))
    labels = load_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz"))
    import pandas as pd

    metrics = pd.read_csv(os.path.join(root, f"{prefix}-morpho.csv"), index_col="index")
    scale = dict(zip(("thickness", "intensity"), DATA_SCALES["morphomnist"]))
    c = np.stack(
        [(metrics[col].to_numpy() - scale[col][0]) / scale[col][1] for col in columns], -1
    ).astype(np.float32)
    return {
        "image": (images.astype(np.float32) / 255.0)[..., None],
        "y": labels.astype(np.int64),
        "c": c,
    }


def load_pendulum(root: str, split: str = "train") -> Dict[str, np.ndarray]:
    from PIL import Image

    d = Path(root) / split
    files = sorted(os.listdir(d))
    scale = np.asarray(DATA_SCALES["pendulum"])
    images, labels = [], []
    for name in files:
        if not name.lower().endswith(".png"):
            continue
        parts = name[:-4].split("_")[1:]
        labels.append([int(p) for p in parts])
        with Image.open(d / name) as im:
            images.append(np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0)
    labels = np.asarray(labels, dtype=np.float32)
    c = (labels - scale[:, 0]) / scale[:, 1]
    return {"image": np.stack(images), "c": c.astype(np.float32)}


def _circuit_regime_mask(lat: np.ndarray) -> np.ndarray:
    """The 'simplified' filtered-regime selection (reference
    `CausalCircuitSimplified`): three disjoint arm-position bands with
    specific light configurations. ``lat`` is in the RAW latent order
    [red, green, blue, arm] (pre-permutation)."""
    r1 = (lat[:, 3] > 0.1) & (lat[:, 3] < 0.4) & (lat[:, 0] > 0.5) & (lat[:, 1] > 0.4) & (lat[:, 2] < 0.2)
    r2 = (lat[:, 3] > 0.4) & (lat[:, 3] < 0.7) & (lat[:, 0] > 0.5) & (lat[:, 2] < 0.2) & (lat[:, 1] < 0.2)
    r3 = (lat[:, 3] > 0.7) & (lat[:, 3] < 1.0) & (lat[:, 0] > 0.5) & (lat[:, 2] > 0.4) & (lat[:, 1] < 0.2)
    return r1 | r2 | r3


def load_circuit(root: str, split: str = "train", image_size: int = 128,
                 simplified: bool = False) -> Dict[str, np.ndarray]:
    from PIL import Image

    root = Path(root)
    files = [root / "test.npz"] if split == "test" else [root / f"train-{k}.npz" for k in range(5)]
    images, labels = [], []
    perm = [3, 2, 1, 0]  # -> [arm, blue, green, red]
    frames = (0, 1) if simplified else (0,)  # simplified uses both stored frames
    for f in files:
        with np.load(f, allow_pickle=True) as data:
            latents, all_imgs = data["original_latents"], data["imgs"]
        for frame in frames:
            lat = latents[:, frame, :]
            imgs = all_imgs[:, frame]
            keep = _circuit_regime_mask(lat) if simplified else np.ones(len(imgs), bool)
            for i in np.nonzero(keep)[0]:
                with Image.open(_io.BytesIO(imgs[i])) as im:
                    im = im.convert("RGB")
                    # torchvision Resize(int) PIL semantics: smaller edge ->
                    # image_size, other edge scaled with int() truncation,
                    # no-op when the smaller edge already matches
                    w, h = im.size
                    if not ((w <= h and w == image_size) or (h <= w and h == image_size)):
                        if w < h:
                            ow, oh = image_size, int(image_size * h / w)
                        else:
                            oh, ow = image_size, int(image_size * w / h)
                        im = im.resize((ow, oh), Image.BILINEAR)
                    images.append(np.asarray(im, dtype=np.float32) / 255.0)
                labels.append(lat[i][perm])
    return {"image": np.stack(images), "c": np.asarray(labels, dtype=np.float32)}


def load_image_folder(root: str, image_size: int, class_cond: bool = False) -> Dict[str, np.ndarray]:
    """Generic folder loader (the reference's celeba path, [-1,1] scaled)."""
    from PIL import Image

    paths = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.split(".")[-1].lower() in ("jpg", "jpeg", "png", "gif"):
                paths.append(os.path.join(dirpath, f))
    images, classes = [], []
    class_names = sorted({os.path.basename(p).split("_")[0] for p in paths}) if class_cond else []
    class_idx = {n: i for i, n in enumerate(class_names)}
    for p in paths:
        with Image.open(p) as im:
            im.load()
            while min(*im.size) >= 2 * image_size:
                im = im.resize(tuple(x // 2 for x in im.size), Image.BOX)
            s = image_size / min(*im.size)
            im = im.resize(tuple(round(x * s) for x in im.size), Image.BICUBIC)
            arr = np.asarray(im.convert("RGB"))
        cy = (arr.shape[0] - image_size) // 2
        cx = (arr.shape[1] - image_size) // 2
        arr = arr[cy:cy + image_size, cx:cx + image_size]
        images.append(arr.astype(np.float32) / 127.5 - 1.0)
        if class_cond:
            classes.append(class_idx[os.path.basename(p).split("_")[0]])
    out = {"image": np.stack(images)}
    if class_cond:
        out["y"] = np.asarray(classes, dtype=np.int64)
    return out


# --------------------------------------------------------------------- #
def batch_iterator(data: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
                   shuffle: bool = True, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite epoch-shuffled batch iterator; ``drop_last`` drops each
    epoch's partial batch."""
    n = len(data["image"])
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, end, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: v[sel] for k, v in data.items()}


def load_data(*, data_dir: str, batch_size: int, image_size: int,
              class_cond: bool = False, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled batches of the training split, the loader picked by the directory name."""
    if not data_dir:
        raise ValueError("unspecified data directory")
    if "morphomnist" in data_dir:
        data = load_morphomnist(data_dir, train=True)
    elif "pendulum" in data_dir:
        data = load_pendulum(data_dir)
    elif "circuit" in data_dir:
        data = load_circuit(data_dir, image_size=image_size)
    else:
        data = load_image_folder(data_dir, image_size, class_cond=class_cond)
    return batch_iterator(data, batch_size, seed=seed)


def load_split(dataset: str, data_dir: str, split: str) -> Dict[str, np.ndarray]:
    """The ``split`` ('train' or 'test') of a real dataset, as the eval CLIs read it."""
    if dataset == "morphomnist":
        return load_morphomnist(data_dir, train=split == "train")
    if dataset == "pendulum":
        return load_pendulum(data_dir, split=split)
    if dataset == "circuit":
        return load_circuit(data_dir, split=split)
    raise ValueError(f"no {split} split loader for dataset {dataset!r}")
