"""The dataset tool, copied from ``inclusivegan_tpu/data/dataset_tool.py``:
the writer, the creators and the verification commands.

``TFRecordExporter`` writes one ``<name>-r{log2res:02d}.tfrecords`` per
resolution (a 2x2 box-filter pyramid down to 4x4) plus ``<name>-rxx.labels``
(float32 .npy). The creators read each source format and write through it,
byte for byte as the JAX package's do: ``create_mnist``, ``create_mnistrgb``
(stacked MNIST, the 1000-mode set), ``create_cifar10``, ``create_cifar100``,
``create_svhn``, ``create_lsun``, ``create_celeba`` (128x128 crop and the
40 attributes), ``create_celebahq``, ``create_from_images`` and
``create_from_hdf5``. ``extract``, ``compare`` and ``display`` verify a
dataset; ``extract`` writes its PNGs with ``utils.misc.write_png``.

Third-party packages are imported where a creator needs them, as in the JAX
package: ``scipy.io`` (SVHN), ``lmdb`` and Pillow (LSUN), Pillow (CelebA,
CelebA-HQ, image folders), ``scipy.ndimage`` and ``cryptography``
(CelebA-HQ), ``h5py`` (HDF5). A missing one raises ``ImportError`` naming
it. The command line is ``python -m inclusivegan_torch.dataset_tool``.
"""


import glob
import gzip
import os
import pickle
import struct
from typing import Optional

import numpy as np

from . import tfrecord


class TFRecordExporter:
    def __init__(self, tfrecord_dir: str, expected_images: int,
                 print_progress: bool = True, progress_interval: int = 10):
        self.tfrecord_dir = tfrecord_dir
        self.tfr_prefix = os.path.join(tfrecord_dir,
                                       os.path.basename(tfrecord_dir))
        self.expected_images = expected_images
        self.cur_images = 0
        self.shape = None
        self.resolution_log2 = None
        self.tfr_files = []
        self.print_progress = print_progress
        self.progress_interval = progress_interval
        os.makedirs(tfrecord_dir, exist_ok=True)
        self._writers = []

    def set_shape(self, shape):
        self.shape = list(shape)
        self.resolution_log2 = int(np.log2(self.shape[1]))
        assert self.shape[0] in (1, 3)
        assert self.shape[1] == self.shape[2] == 2 ** self.resolution_log2
        for lod in range(self.resolution_log2 - 1):
            path = f"{self.tfr_prefix}-r{self.resolution_log2 - lod:02d}.tfrecords"
            self.tfr_files.append(path)
            self._writers.append(open(path, "wb"))

    def add_image(self, img: np.ndarray):
        if self.print_progress and self.cur_images % self.progress_interval == 0:
            print(f"{self.cur_images} / {self.expected_images}\r", end="",
                  flush=True)
        if self.shape is None:
            self.set_shape(img.shape)
        assert list(img.shape) == self.shape
        img = img.astype(np.float32)
        for lod, writer in enumerate(self._writers):
            if lod:
                img = (img[:, 0::2, 0::2] + img[:, 0::2, 1::2] +
                       img[:, 1::2, 0::2] + img[:, 1::2, 1::2]) * 0.25
            quant = np.rint(img).clip(0, 255).astype(np.uint8)
            tfrecord.write_record(writer, tfrecord.encode_image_example(quant))
        self.cur_images += 1

    def add_labels(self, labels: np.ndarray):
        if self.print_progress:
            print(f"{self.cur_images} / {self.expected_images}")
        assert labels.shape[0] == self.cur_images
        with open(self.tfr_prefix + "-rxx.labels", "wb") as f:
            np.save(f, labels.astype(np.float32))

    def close(self):
        for w in self._writers:
            w.close()
        self._writers = []
        if self.print_progress:
            print(f"Added {self.cur_images} images.")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()



# ---------------------------------------------------------------------------
# Source-format readers
# ---------------------------------------------------------------------------

def _load_mnist_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051
        data = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
    return data


def _load_mnist_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049
        return np.frombuffer(f.read(), np.uint8)


# ---------------------------------------------------------------------------
# Creators
# ---------------------------------------------------------------------------

def create_mnist(tfrecord_dir: str, mnist_dir: str):
    """28×28 MNIST zero-padded to 32×32, one-hot 10 labels."""
    images = _load_mnist_images(_find(mnist_dir, "train-images-idx3-ubyte*"))
    labels = _load_mnist_labels(_find(mnist_dir, "train-labels-idx1-ubyte*"))
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)])[:, None]  # [N,1,32,32]
    onehot = np.zeros((labels.size, 10), np.float32)
    onehot[np.arange(labels.size), labels] = 1.0
    with TFRecordExporter(tfrecord_dir, images.shape[0]) as tfr:
        for idx in range(images.shape[0]):
            tfr.add_image(images[idx])
        tfr.add_labels(onehot)


def create_mnistrgb(tfrecord_dir: str, mnist_dir: str,
                    num_images: int = 1000000, random_seed: int = 123):
    """Stacked MNIST: 3 random digits as RGB channels, 32×32, 1000-way
    one-hot label d_R + 10·d_G + 100·d_B."""
    images = _load_mnist_images(_find(mnist_dir, "train-images-idx3-ubyte*"))
    labels = _load_mnist_labels(_find(mnist_dir, "train-labels-idx1-ubyte*"))
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)])
    rnd = np.random.RandomState(random_seed)
    out_labels = np.zeros((num_images, 1000), np.float32)
    with TFRecordExporter(tfrecord_dir, num_images) as tfr:
        for idx in range(num_images):
            sel = rnd.randint(images.shape[0], size=3)
            tfr.add_image(images[sel])  # [3,32,32] = RGB stack
            # labels are uint8; promote BEFORE scaling or 100*d_B wraps mod 256
            mode = (int(labels[sel[0]]) + 10 * int(labels[sel[1]])
                    + 100 * int(labels[sel[2]]))
            out_labels[idx, mode] = 1.0
        tfr.add_labels(out_labels)


def create_cifar10(tfrecord_dir: str, cifar10_dir: str):
    """CIFAR-10 train split, one-hot 10 labels."""
    images, labels = [], []
    for batch in range(1, 6):
        with open(os.path.join(cifar10_dir, f"data_batch_{batch}"), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        images.append(data["data"].reshape(-1, 3, 32, 32))
        labels.append(np.array(data["labels"], np.uint8))
    images = np.concatenate(images)
    labels = np.concatenate(labels)
    onehot = np.zeros((labels.size, 10), np.float32)
    onehot[np.arange(labels.size), labels] = 1.0
    order = np.arange(images.shape[0])
    with TFRecordExporter(tfrecord_dir, images.shape[0]) as tfr:
        for idx in order:
            tfr.add_image(images[idx])
        tfr.add_labels(onehot[order])


def create_cifar100(tfrecord_dir: str, cifar100_dir: str):
    """CIFAR-100 train split, one-hot fine labels."""
    with open(os.path.join(cifar100_dir, "train"), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    images = data["data"].reshape(-1, 3, 32, 32)
    labels = np.array(data["fine_labels"], np.uint8)
    onehot = np.zeros((labels.size, 100), np.float32)
    onehot[np.arange(labels.size), labels] = 1.0
    with TFRecordExporter(tfrecord_dir, images.shape[0]) as tfr:
        for img in images:
            tfr.add_image(img)
        tfr.add_labels(onehot)


def create_svhn(tfrecord_dir: str, svhn_dir: str):
    """SVHN train split from the .mat files."""
    import scipy.io
    images, labels = [], []
    for batch in ("train_32x32.mat",):
        data = scipy.io.loadmat(os.path.join(svhn_dir, batch))
        images.append(np.transpose(data["X"], (3, 2, 0, 1)))
        labels.append(data["y"].flatten() % 10)  # '10' encodes digit 0
    images = np.concatenate(images)
    labels = np.concatenate(labels).astype(np.uint8)
    onehot = np.zeros((labels.size, 10), np.float32)
    onehot[np.arange(labels.size), labels] = 1.0
    with TFRecordExporter(tfrecord_dir, images.shape[0]) as tfr:
        for img in images:
            tfr.add_image(img)
        tfr.add_labels(onehot)


def create_lsun(tfrecord_dir: str, lmdb_dir: str, resolution: int = 256,
                max_images: Optional[int] = None):
    """LSUN bedroom-style lmdb. Needs the optional
    ``lmdb`` package; center-crops to square and box-resizes to
    ``resolution``."""
    import io
    import lmdb  # gated optional dependency
    from PIL import Image
    with lmdb.open(lmdb_dir, readonly=True).begin(write=False) as txn:
        total = max_images or txn.stat()["entries"]
        with TFRecordExporter(tfrecord_dir, total) as tfr:
            for _key, value in txn.cursor():
                try:
                    img = Image.open(io.BytesIO(value))
                    img = img.convert("RGB")
                    arr = np.asarray(img)
                except Exception:
                    continue
                crop = min(arr.shape[0], arr.shape[1])
                y0 = (arr.shape[0] - crop) // 2
                x0 = (arr.shape[1] - crop) // 2
                arr = arr[y0:y0 + crop, x0:x0 + crop]
                img = Image.fromarray(arr).resize((resolution, resolution),
                                                  Image.LANCZOS)
                tfr.add_image(np.asarray(img).transpose(2, 0, 1))
                if tfr.cur_images >= total:
                    break


def create_celeba(tfrecord_dir: str, celeba_dir: str, cx: int = 89,
                  cy: int = 121, num_images: Optional[int] = None,
                  attr_file: Optional[str] = None):
    """CelebA 128×128 center crop at (cx,cy)=(89,121) with the 40 binary
    attributes as labels."""
    from PIL import Image
    glob_pattern = os.path.join(celeba_dir, "img_align_celeba", "*.jpg")
    image_filenames = sorted(glob.glob(glob_pattern))
    if not image_filenames:
        image_filenames = sorted(glob.glob(os.path.join(celeba_dir, "*.jpg")))
    assert image_filenames, f"no jpgs under {celeba_dir}"
    if num_images is not None:
        image_filenames = image_filenames[:num_images]

    attrs = None
    if attr_file is None:
        guess = os.path.join(celeba_dir, "Anno", "list_attr_celeba.txt")
        attr_file = guess if os.path.exists(guess) else None
    if attr_file is not None:
        attrs = load_celeba_attributes(attr_file)

    labels = []
    with TFRecordExporter(tfrecord_dir, len(image_filenames)) as tfr:
        for fname in image_filenames:
            img = np.asarray(Image.open(fname))
            assert img.shape[2] == 3
            img = img[cy - 64: cy + 64, cx - 64: cx + 64]
            tfr.add_image(img.transpose(2, 0, 1))
            if attrs is not None:
                labels.append(attrs[1].get(os.path.basename(fname),
                                           np.zeros(40, np.float32)))
        if labels:
            tfr.add_labels(np.stack(labels))


def create_celebahq(tfrecord_dir: str, celeba_dir: str, delta_dir: str,
                    out_img_dir: Optional[str] = None, num_threads: int = 4,
                    num_tasks: int = 100, shuffle: bool = True,
                    strict: bool = True, num_images: Optional[int] = None,
                    expected_images: int = 202599):
    """CelebA-HQ 1024×1024 reconstruction from raw CelebA + encrypted deltas.

    Pipeline per image: landmark-oriented crop/zoom/pad of the in-the-wild
    jpg (eye/mouth geometry), QUAD-transform to 4096², LANCZOS resize to
    1024², then add the bz2-compressed delta decrypted with
    PBKDF2(orig jpg bytes) + Fernet — the deltas are keyed on the original
    CelebA files so only licensed holders can reconstruct.

    ``strict=True`` verifies the per-image proc/final MD5s from
    ``image_list.txt``; bit-exactness additionally requires the historical
    Pillow 3.1.1 / libjpeg 8d resampling (the original tool refuses any
    other version). With modern Pillow pass ``strict=False``:
    geometry and deltas still apply but checksums are reported, not enforced.

    PNGs go to ``out_img_dir`` when given, and the TFRecord pyramid is
    written too, so the output is directly trainable.
    """
    import base64
    import bz2
    import hashlib
    import threading
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    import scipy.ndimage
    from PIL import Image

    _zip_cache: dict = {}
    _zip_lock = threading.Lock()

    jpgs = glob.glob(os.path.join(celeba_dir, "img_celeba", "*.jpg"))
    assert len(jpgs) == expected_images, \
        f"expected {expected_images} img_celeba jpgs, found {len(jpgs)}"
    with open(os.path.join(celeba_dir, "Anno",
                           "list_landmarks_celeba.txt")) as f:
        landmarks = [[float(v) for v in line.split()[1:]]
                     for line in f.read().splitlines()[2:] if line.strip()]
    landmarks = np.float32(landmarks).reshape(-1, 5, 2)

    zips = glob.glob(os.path.join(delta_dir, "delta*.zip"))
    if expected_images == 202599:  # full-set invariant
        assert len(zips) == 30, f"expected 30 delta zips, found {len(zips)}"
    with open(os.path.join(delta_dir, "image_list.txt")) as f:
        lines = [line.split() for line in f if line.strip()]
    fields = {}
    for col, name in enumerate(lines[0]):
        conv = int if name.endswith("idx") else str
        fields[name] = [conv(row[col]) for row in lines[1:]]
    indices = np.array(fields["idx"])
    if num_images is not None:
        indices = indices[:num_images]

    def rot90(v):
        return np.array([-v[1], v[0]])

    def process(idx: int) -> np.ndarray:
        orig_idx = fields["orig_idx"][idx]
        orig_file = fields["orig_file"][idx]
        orig_path = os.path.join(celeba_dir, "img_celeba", orig_file)
        img = Image.open(orig_path)

        # Oriented crop rectangle from the 5 facial landmarks.
        lm = landmarks[orig_idx]
        eye_avg = (lm[0] + lm[1]) * 0.5 + 0.5
        mouth_avg = (lm[3] + lm[4]) * 0.5 + 0.5
        eye_to_eye = lm[1] - lm[0]
        eye_to_mouth = mouth_avg - eye_avg
        x = eye_to_eye - rot90(eye_to_mouth)
        x /= np.hypot(*x)
        x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
        y = rot90(x)
        c = eye_avg + eye_to_mouth * 0.1
        quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
        zoom = 1024 / (np.hypot(*x) * 2)

        shrink = int(np.floor(0.5 / zoom))
        if shrink > 1:
            size = (int(np.round(img.size[0] / shrink)),
                    int(np.round(img.size[1] / shrink)))
            img = img.resize(size, Image.LANCZOS)
            quad /= shrink
            zoom *= shrink

        border = max(int(np.round(1024 * 0.1 / zoom)), 3)
        crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
                int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
        crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
                min(crop[2] + border, img.size[0]),
                min(crop[3] + border, img.size[1]))
        if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
            img = img.crop(crop)
            quad -= crop[0:2]

        superres = int(np.exp2(np.ceil(np.log2(zoom))))
        if superres > 1:
            img = img.resize((img.size[0] * superres, img.size[1] * superres),
                             Image.LANCZOS)
            quad *= superres
            zoom /= superres

        pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
               int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
        pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
               max(pad[2] - img.size[0] + border, 0),
               max(pad[3] - img.size[1] + border, 0))
        if max(pad) > border - 4:
            pad = np.maximum(pad, int(np.round(1024 * 0.3 / zoom)))
            arr = np.pad(np.float32(img),
                         ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
                         "reflect")
            h, w, _ = arr.shape
            yy, xx, _ = np.mgrid[:h, :w, :1]
            mask = 1.0 - np.minimum(
                np.minimum(np.float32(xx) / pad[0], np.float32(yy) / pad[1]),
                np.minimum(np.float32(w - 1 - xx) / pad[2],
                           np.float32(h - 1 - yy) / pad[3]))
            blur = 1024 * 0.02 / zoom
            arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) \
                * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
            arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
            img = Image.fromarray(
                np.uint8(np.clip(np.round(arr), 0, 255)), "RGB")
            quad += pad[0:2]

        img = img.transform((4096, 4096), Image.QUAD,
                            (quad + 0.5).flatten(), Image.BILINEAR)
        img = img.resize((1024, 1024), Image.LANCZOS)
        img = np.asarray(img).transpose(2, 0, 1)

        proc_md5 = hashlib.md5(img.tobytes()).hexdigest()
        if strict and proc_md5 != fields["proc_md5"][idx]:
            raise RuntimeError(
                f"proc md5 mismatch for idx {idx} ({proc_md5}): bit-exact "
                "reconstruction needs Pillow 3.1.1 + libjpeg 8d "
                "; rerun with strict=False "
                "to accept modern resampling")

        # Decrypt + apply the delta (keyed on the original jpg bytes).
        import cryptography.fernet
        import cryptography.hazmat.backends
        import cryptography.hazmat.primitives.hashes
        import cryptography.hazmat.primitives.kdf.pbkdf2
        zpath = os.path.join(delta_dir, "deltas%05d.zip" % (idx - idx % 1000))
        with _zip_lock:
            # cached handles: re-parsing a ~1000-entry central directory per
            # image costs minutes over the full 202k set; ZipFile.read on a
            # shared handle isn't thread-safe, so reads stay under the lock
            zf = _zip_cache.get(zpath)
            if zf is None:
                zf = _zip_cache[zpath] = zipfile.ZipFile(zpath, "r")
            delta_bytes = zf.read("delta%05d.dat" % idx)
        with open(orig_path, "rb") as f:
            orig_bytes = f.read()
        kdf = cryptography.hazmat.primitives.kdf.pbkdf2.PBKDF2HMAC(
            algorithm=cryptography.hazmat.primitives.hashes.SHA256(),
            length=32, salt=orig_file.encode(), iterations=100000,
            backend=cryptography.hazmat.backends.default_backend())
        key = base64.urlsafe_b64encode(kdf.derive(orig_bytes))
        delta = np.frombuffer(
            bz2.decompress(
                cryptography.fernet.Fernet(key).decrypt(delta_bytes)),
            dtype=np.uint8).reshape(3, 1024, 1024)
        img = img + delta  # uint8 wraparound, as in the original tool

        final_md5 = hashlib.md5(img.tobytes()).hexdigest()
        if strict and final_md5 != fields["final_md5"][idx]:
            raise RuntimeError(f"final md5 mismatch for idx {idx}")
        return img

    order = (np.random.RandomState(123).permutation(indices.size)
             if shuffle else np.arange(indices.size))
    if out_img_dir is not None:
        os.makedirs(out_img_dir, exist_ok=True)
    with TFRecordExporter(tfrecord_dir, indices.size) as tfr:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            todo = indices[order].tolist()
            for start in range(0, len(todo), num_tasks):
                chunk = todo[start:start + num_tasks]
                # futures re-raise worker exceptions here
                for img in pool.map(process, chunk):
                    if out_img_dir is not None:
                        Image.fromarray(
                            img.transpose(1, 2, 0), "RGB").save(os.path.join(
                                out_img_dir, "%06d.png" % tfr.cur_images))
                    tfr.add_image(img)
    for zf in _zip_cache.values():
        zf.close()


def load_celeba_attributes(attr_file: str):
    """Parse list_attr_celeba.txt → (attr_names, {filename: 0/1 vector})
    (used for minority-inclusion filtering, training_loop.py:175-180,416-427)."""
    with open(attr_file) as f:
        lines = f.read().splitlines()
    attr_names = lines[1].split()
    table = {}
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        vals = np.array([1.0 if v == "1" else 0.0 for v in parts[1:]],
                        np.float32)
        table[parts[0]] = vals
    return attr_names, table


def create_from_images(tfrecord_dir: str, image_dir: str,
                       shuffle: bool = False, random_seed: int = 123):
    """Folder of same-sized power-of-two PNG/JPG images."""
    from PIL import Image
    image_filenames = sorted(
        glob.glob(os.path.join(image_dir, "*.png")) +
        glob.glob(os.path.join(image_dir, "*.jpg")) +
        glob.glob(os.path.join(image_dir, "*.jpeg")))
    assert image_filenames, f"no images in {image_dir}"
    order = (np.random.RandomState(random_seed).permutation(len(image_filenames))
             if shuffle else np.arange(len(image_filenames)))
    with TFRecordExporter(tfrecord_dir, len(image_filenames)) as tfr:
        for idx in order:
            img = np.asarray(Image.open(image_filenames[idx]))
            if img.ndim == 2:
                img = img[None]
            else:
                img = img.transpose(2, 0, 1)
            tfr.add_image(img)


def create_from_hdf5(tfrecord_dir: str, hdf5_filename: str,
                     shuffle: bool = False, random_seed: int = 123):
    import h5py  # gated: optional dependency
    with h5py.File(hdf5_filename, "r") as h5:
        key = max(h5.keys(), key=lambda k: np.prod(h5[k].shape[1:]))
        data = h5[key]
        order = (np.random.RandomState(random_seed).permutation(data.shape[0])
                 if shuffle else np.arange(data.shape[0]))
        with TFRecordExporter(tfrecord_dir, data.shape[0]) as tfr:
            for idx in order:
                tfr.add_image(np.asarray(data[idx]))


# ---------------------------------------------------------------------------
# Verification commands
# ---------------------------------------------------------------------------

def extract(tfrecord_dir: str, output_dir: str, num_images: Optional[int] = None):
    from ..utils.misc import write_png
    from .dataset import TFRecordDataset
    ds = TFRecordDataset(tfrecord_dir, max_label_size=0)
    os.makedirs(output_dir, exist_ok=True)
    images = ds.get_all_images()
    n = len(images) if num_images is None else min(num_images, len(images))
    for idx in range(n):
        img = images[idx]  # [1, H, W] greyscale or [3, H, W] RGB
        write_png(os.path.join(output_dir, f"img{idx:08d}.png"),
                  img[0] if img.shape[0] == 1 else img.transpose(1, 2, 0))
    print(f"Extracted {n} images to {output_dir}")


def compare(tfrecord_dir_a: str, tfrecord_dir_b: str,
            ignore_labels: bool = False) -> bool:
    from .dataset import TFRecordDataset
    da = TFRecordDataset(tfrecord_dir_a, max_label_size=0 if ignore_labels else "full")
    db = TFRecordDataset(tfrecord_dir_b, max_label_size=0 if ignore_labels else "full")
    same = (da.num_images == db.num_images and
            np.array_equal(da.get_all_images(), db.get_all_images()) and
            (ignore_labels or np.array_equal(da.get_all_labels(),
                                             db.get_all_labels())))
    print("identical" if same else "DIFFERENT")
    return same


def display(tfrecord_dir: str):
    from .dataset import TFRecordDataset
    ds = TFRecordDataset(tfrecord_dir, max_label_size="full")
    print(f"{ds.num_images} images, shape {ds.shape}, "
          f"label size {ds.label_size}")


def _find(directory: str, pattern: str) -> str:
    matches = glob.glob(os.path.join(directory, pattern))
    assert matches, f"no {pattern} in {directory}"
    return matches[0]
