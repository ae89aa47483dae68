"""The port's dataset tool (``inclusivegan_torch/data/dataset_tool.py`` and
its command line ``inclusivegan_torch/dataset_tool.py``) against the JAX
package's, and the port's host helpers (``utils/misc.py``: ``read_png``
and the helpers copied from the JAX package).

Every creator runs on the same tiny seeded sources in both packages, and
the two output directories must hold the same files, byte for byte.
``extract``'s PNGs must be pixel for pixel the JAX package's (read here
with Pillow), ``compare`` and ``display`` must print the same lines, and
each subcommand of the port's command line must call its function with
the arguments the repository's ``dataset_tool.py`` passes.
"""

import base64
import bz2
import gzip
import importlib.util
import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import inclusivegan_torch.dataset_tool as port_cli
import inclusivegan_tpu.data.dataset_tool as jdt
import inclusivegan_tpu.utils.misc as jmisc
from inclusivegan_torch.data import dataset_tool as tdt
from inclusivegan_torch.utils import misc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_idx(d, n, rnd, gz=False):
    images = rnd.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rnd.randint(0, 10, n).astype(np.uint8)
    opener, ext = (gzip.open, ".gz") if gz else (open, "")
    with opener(os.path.join(d, "train-images-idx3-ubyte" + ext), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(os.path.join(d, "train-labels-idx1-ubyte" + ext), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _celebahq_sources(root, rnd):
    """The synthetic 2-image CelebA-HQ corpus of ``tests/test_data.py``:
    in-the-wild jpgs, landmarks, and a random delta per image encrypted
    with PBKDF2 of the original jpg and Fernet."""
    import cryptography.fernet
    import cryptography.hazmat.backends
    import cryptography.hazmat.primitives.hashes
    import cryptography.hazmat.primitives.kdf.pbkdf2
    import zipfile
    n = 2
    celeba, deltas = os.path.join(root, "celeba_hq"), os.path.join(root, "deltas")
    os.makedirs(os.path.join(celeba, "img_celeba"))
    os.makedirs(os.path.join(celeba, "Anno"))
    os.makedirs(deltas)
    names = [f"{i + 1:06d}.jpg" for i in range(n)]
    for name in names:
        Image.fromarray(rnd.randint(0, 256, (218, 178, 3), np.uint8), "RGB").save(
            os.path.join(celeba, "img_celeba", name), quality=95)
    with open(os.path.join(celeba, "Anno", "list_landmarks_celeba.txt"), "w") as f:
        f.write(f"{n}\nlefteye_x lefteye_y ...\n")
        for name in names:
            f.write(f"{name} 70 112 108 112 89 135 72 153 106 153\n")
    delta = rnd.randint(0, 256, (3, 1024, 1024), np.uint8)
    with zipfile.ZipFile(os.path.join(deltas, "deltas00000.zip"), "w") as zf:
        for i, name in enumerate(names):
            with open(os.path.join(celeba, "img_celeba", name), "rb") as f:
                orig = f.read()
            kdf = cryptography.hazmat.primitives.kdf.pbkdf2.PBKDF2HMAC(
                algorithm=cryptography.hazmat.primitives.hashes.SHA256(), length=32,
                salt=name.encode(), iterations=100000,
                backend=cryptography.hazmat.backends.default_backend())
            key = base64.urlsafe_b64encode(kdf.derive(orig))
            zf.writestr(f"delta{i:05d}.dat", cryptography.fernet.Fernet(key).encrypt(
                bz2.compress(delta.tobytes())))
    with open(os.path.join(deltas, "image_list.txt"), "w") as f:
        f.write("idx orig_idx orig_file proc_md5 final_md5\n")
        for i, name in enumerate(names):
            f.write(f"{i} {i} {name} x x\n")
    return celeba, deltas


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Every creator's input, tiny and seeded."""
    import h5py
    import scipy.io
    root = str(tmp_path_factory.mktemp("sources"))
    rnd = np.random.RandomState(0)
    src = {k: os.path.join(root, k) for k in ("mnist", "mnist_gz", "cifar10", "cifar100",
                                              "svhn", "celeba", "images")}
    for d in src.values():
        os.makedirs(d)
    _write_idx(src["mnist"], 40, rnd)
    _write_idx(src["mnist_gz"], 30, rnd, gz=True)
    for b in range(1, 6):
        with open(os.path.join(src["cifar10"], f"data_batch_{b}"), "wb") as f:
            pickle.dump({"data": rnd.randint(0, 256, (4, 3072)).astype(np.uint8),
                         "labels": rnd.randint(0, 10, 4).tolist()}, f)
    with open(os.path.join(src["cifar100"], "train"), "wb") as f:
        pickle.dump({"data": rnd.randint(0, 256, (6, 3072)).astype(np.uint8),
                     "fine_labels": rnd.randint(0, 100, 6).tolist()}, f)
    scipy.io.savemat(os.path.join(src["svhn"], "train_32x32.mat"),
                     {"X": rnd.randint(0, 256, (32, 32, 3, 5)).astype(np.uint8),
                      "y": rnd.randint(1, 11, (5, 1)).astype(np.uint8)})
    os.makedirs(os.path.join(src["celeba"], "img_align_celeba"))
    os.makedirs(os.path.join(src["celeba"], "Anno"))
    names = [f"{i + 1:06d}.jpg" for i in range(3)]
    for name in names:
        Image.fromarray(rnd.randint(0, 256, (218, 178, 3), np.uint8), "RGB").save(
            os.path.join(src["celeba"], "img_align_celeba", name), quality=90)
    with open(os.path.join(src["celeba"], "Anno", "list_attr_celeba.txt"), "w") as f:
        f.write("3\n" + " ".join(f"attr{j}" for j in range(40)) + "\n")
        for name in names:
            f.write(name + " " + " ".join(rnd.choice(["1", "-1"], 40)) + "\n")
    for i in range(3):
        Image.fromarray(rnd.randint(0, 256, (16, 16, 3), np.uint8), "RGB").save(
            os.path.join(src["images"], f"{i}.png"))
    Image.fromarray(rnd.randint(0, 256, (16, 16, 3), np.uint8), "RGB").save(
        os.path.join(src["images"], "3.jpg"), quality=90)
    src["hdf5"] = os.path.join(root, "set.h5")
    with h5py.File(src["hdf5"], "w") as h5:
        h5["data16x16"] = rnd.randint(0, 256, (5, 3, 16, 16)).astype(np.uint8)
        h5["data8x8"] = rnd.randint(0, 256, (5, 3, 8, 8)).astype(np.uint8)
    src["celebahq"], src["deltas"] = _celebahq_sources(root, rnd)
    return src


CREATORS = {
    "create_mnist": lambda s: dict(mnist_dir=s["mnist"]),
    "create_mnist_gz": lambda s: dict(mnist_dir=s["mnist_gz"]),
    "create_mnistrgb": lambda s: dict(mnist_dir=s["mnist"], num_images=50, random_seed=7),
    "create_cifar10": lambda s: dict(cifar10_dir=s["cifar10"]),
    "create_cifar100": lambda s: dict(cifar100_dir=s["cifar100"]),
    "create_svhn": lambda s: dict(svhn_dir=s["svhn"]),
    "create_celeba": lambda s: dict(celeba_dir=s["celeba"], num_images=2),
    "create_celebahq": lambda s: dict(celeba_dir=s["celebahq"], delta_dir=s["deltas"],
                                      shuffle=False, strict=False, expected_images=2,
                                      num_threads=2),
    "create_from_images": lambda s: dict(image_dir=s["images"], shuffle=True),
    "create_from_hdf5": lambda s: dict(hdf5_filename=s["hdf5"], shuffle=True),
}


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("creator", sorted(CREATORS))
def test_creator_writes_the_jax_packages_bytes(sources, tmp_path, creator):
    fn = creator.replace("_gz", "")
    kwargs = CREATORS[creator](sources)
    out = {}
    for name, module in (("jax", jdt), ("port", tdt)):
        d = str(tmp_path / name / "set")
        getattr(module, fn)(d, **kwargs)
        out[name] = _files(d)
    assert any(k.endswith(".tfrecords") for k in out["jax"])
    assert set(out["port"]) == set(out["jax"])
    for k, v in out["jax"].items():
        assert out["port"][k] == v, k


def test_create_lsun_needs_lmdb_in_both_packages(tmp_path):
    if importlib.util.find_spec("lmdb") is not None:
        pytest.skip("lmdb is installed here")
    for module in (jdt, tdt):
        with pytest.raises(ImportError, match="lmdb"):
            module.create_lsun(str(tmp_path / "lsun"), str(tmp_path / "db"))


@pytest.fixture(scope="module")
def mnistrgb(sources, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rgb") / "rgb")
    tdt.create_mnistrgb(d, sources["mnist"], num_images=12)
    return d


@pytest.mark.parametrize("which", ["rgb", "gray"])
def test_extract_writes_the_jax_packages_pixels(sources, mnistrgb, tmp_path, capsys, which):
    d = mnistrgb
    if which == "gray":
        d = str(tmp_path / "gray")
        tdt.create_mnist(d, sources["mnist"])
    capsys.readouterr()
    lines = {}
    for name, module in (("jax", jdt), ("port", tdt)):
        module.extract(d, str(tmp_path / f"x_{name}"), num_images=5)
        lines[name] = capsys.readouterr().out.replace(f"x_{name}", "x")
    assert lines["port"] == lines["jax"]
    names = sorted(os.listdir(tmp_path / "x_jax"))
    assert names == sorted(os.listdir(tmp_path / "x_port")) == [
        f"img{i:08d}.png" for i in range(5)]
    for n in names:
        want = Image.open(tmp_path / "x_jax" / n)
        got = Image.open(tmp_path / "x_port" / n)
        assert got.mode == want.mode == ("RGB" if which == "rgb" else "L")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(misc.read_png(str(tmp_path / "x_port" / n)),
                                      np.asarray(want))


def test_compare_and_display_print_the_jax_packages_lines(sources, mnistrgb, tmp_path,
                                                          capsys):
    other = str(tmp_path / "other")
    tdt.create_mnistrgb(other, sources["mnist"], num_images=12, random_seed=5)
    capsys.readouterr()
    out = {}
    for name, module in (("jax", jdt), ("port", tdt)):
        results = (module.compare(mnistrgb, mnistrgb), module.compare(mnistrgb, other),
                   module.compare(mnistrgb, other, ignore_labels=True))
        module.display(mnistrgb)
        out[name] = (results, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (True, False, False)


def _load_root_cli():
    spec = importlib.util.spec_from_file_location("root_dataset_tool",
                                                  os.path.join(ROOT, "dataset_tool.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CLI_LINES = [
    ["display", "D"], ["extract", "D", "OUT", "--num_images", "3"],
    ["compare", "A", "B", "--ignore_labels", "1"], ["create_mnist", "D", "M"],
    ["create_mnistrgb", "D", "M", "--num_images", "2400"], ["create_cifar10", "D", "C"],
    ["create_cifar100", "D", "C"], ["create_svhn", "D", "S"],
    ["create_lsun", "D", "L", "--resolution", "128", "--max_images", "9"],
    ["create_celeba", "D", "C", "--cx", "90", "--num_images", "4", "--attr_file", "a.txt"],
    ["create_celebahq", "D", "C", "X", "--strict", "0", "--expected_images", "2"],
    ["create_from_images", "D", "I", "--shuffle", "1"], ["create_from_hdf5", "D", "H"],
]


def test_cli_subcommands_call_what_the_root_tool_calls(monkeypatch):
    root_cli = _load_root_cli()
    calls = {"jax": [], "port": []}
    for argv in CLI_LINES:
        for name, cli in (("jax", root_cli), ("port", port_cli)):
            monkeypatch.setattr(cli.dt, argv[0],
                                lambda _n=name, _c=argv[0], **kw: calls[_n].append((_c, kw)))
        monkeypatch.setattr(sys, "argv", ["dataset_tool.py", *argv])
        root_cli.main()
        port_cli.main(argv)
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == len(CLI_LINES)


# ---------------------------------------------------------------------------
# utils/misc.py: read_png and the helpers copied from the JAX package

def _png_with_filters(path, img, interlace=0):
    """An 8-bit PNG whose rows use filter types 0-4 in turn (the encoder of
    the PNG specification), so that a decoder meets every filter."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int32)
    out, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        kind, line = y % 5, rows[y]
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [np.zeros_like(line), left, prev, (left + prev) >> 1, paeth][kind]
        out.append(bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = line
    color = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                    0, 0, interlace))
                + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b""))


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_matches_pillow(tmp_path, mode):
    """PNGs that Pillow writes (adaptive filters: None, Sub, Up, Paeth) and
    PNGs whose rows cycle through all five filter types, read by read_png
    and by Pillow."""
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    rnd = np.random.RandomState(c)
    yy, xx = np.mgrid[:24, :19]
    smooth = np.where(yy < 12, 128 + 2 * xx - 2 * yy, rnd.randint(0, 256, (24, 19)))
    img = np.stack([(smooth + 40 * i) % 256 for i in range(c)], -1).astype(np.uint8)
    img = img[..., 0] if c == 1 else img
    for i, write in enumerate((lambda p: Image.fromarray(img, mode).save(p),
                               lambda p: _png_with_filters(p, img))):
        path = str(tmp_path / f"{i}.png")
        write(path)
        np.testing.assert_array_equal(misc.read_png(path), np.asarray(Image.open(path)))
        np.testing.assert_array_equal(misc.read_png(path), img)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    rgb = np.zeros((4, 4, 3), np.uint8)
    for name, image in (("p", Image.fromarray(rgb).convert("P")),
                        ("i16", Image.fromarray(np.zeros((4, 4), np.uint16)))):
        path = str(tmp_path / f"{name}.png")
        image.save(path)
        with pytest.raises(ValueError, match="read_png reads 8-bit"):
            misc.read_png(path)
    path = str(tmp_path / "interlaced.png")
    _png_with_filters(path, rgb, interlace=1)  # the header alone says so
    with pytest.raises(ValueError, match="interlace 1"):
        misc.read_png(path)


def test_misc_helpers_match_the_jax_packages(tmp_path):
    rnd = np.random.RandomState(0)
    u8 = rnd.randint(0, 256, (2, 3, 4, 4)).astype(np.uint8)
    f = rnd.uniform(-1.2, 1.2, (2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(misc.convert_images_from_uint8(u8, [-1, 1]),
                                  jmisc.convert_images_from_uint8(u8, [-1, 1]))
    for nhwc in (False, True):
        np.testing.assert_array_equal(misc.convert_images_to_uint8(f, nchw_to_nhwc=nhwc),
                                      jmisc.convert_images_to_uint8(f, nchw_to_nhwc=nhwc))
    for obj in ({"a": 1}, lambda: 0):
        assert misc.is_pickleable(obj) == jmisc.is_pickleable(obj)
    for s in ("file:///x", "https://h/x", "/x", 3):
        assert misc.is_url(s) == jmisc.is_url(s)
    path = tmp_path / "o.pkl"
    misc.save_pkl({"k": [1, 2]}, str(path))
    assert misc.load_pkl(str(path)) == misc.load_pkl(f"file://{path}") == {"k": [1, 2]}
    assert misc.open_url(str(path)).read() == path.read_bytes()
    with pytest.raises(ValueError, match="local files only"):
        misc.open_url("https://example.invalid/x.pkl")
