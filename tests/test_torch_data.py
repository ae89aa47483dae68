"""The port's data path and schedule against the JAX package's, on the CPU:
TFRecord shards written by either package read the same in the other
(images, labels, ``max_label_size``), ``get_minibatch_np`` gives the same
stream with shuffle off and on, the ``Prefetcher`` delivers exactly the
inline stream, ``load_celeba_attributes`` parses a small file, and
``training_schedule`` and ``resume_rampup_scale`` agree over a grid. All
comparisons are exact."""

import os

import numpy as np
import pytest

from inclusivegan_torch.data import dataset as tdata
from inclusivegan_torch.data import dataset_tool as ttool
from inclusivegan_torch.data import tfrecord as ttfr
from inclusivegan_torch.training import schedule as tsched
from inclusivegan_tpu.data import dataset as jdata
from inclusivegan_tpu.data import dataset_tool as jtool
from inclusivegan_tpu.data import tfrecord as jtfr
from inclusivegan_tpu.training import schedule as jsched

N, RES, LABELS = 20, 16, 5


def _write(tool, root, name):
    r = np.random.RandomState(0)
    images = r.randint(0, 256, (N, 3, RES, RES)).astype(np.uint8)
    labels = r.randint(0, 2, (N, LABELS)).astype(np.float32)
    d = os.path.join(root, name)
    with tool.TFRecordExporter(d, N, print_progress=False) as tfr:
        for img in images:
            tfr.add_image(img)
        tfr.add_labels(labels)
    return d, images, labels


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_read_the_same_in_both_packages(tmp_path, writer):
    d, images, labels = _write(jtool if writer == "jax" else ttool, str(tmp_path), "toy")
    assert sorted(os.listdir(d)) == [f"toy-r{r:02d}.tfrecords" for r in (2, 3, 4)] + [
        "toy-rxx.labels"]
    for max_label_size in (0, 3, "full"):
        jd = jdata.TFRecordDataset(d, max_label_size=max_label_size)
        td = tdata.TFRecordDataset(d, max_label_size=max_label_size)
        np.testing.assert_array_equal(td.get_all_images(), images)
        np.testing.assert_array_equal(td.get_all_images(), jd.get_all_images())
        np.testing.assert_array_equal(td.get_all_labels(), jd.get_all_labels())
        assert td.label_size == jd.label_size == {0: 0, 3: 3, "full": LABELS}[max_label_size]
        assert (td.shape, td.resolution_log2, td.dynamic_range) == (
            jd.shape, jd.resolution_log2, jd.dynamic_range)
    for res in (4, 8):
        np.testing.assert_array_equal(
            tdata.TFRecordDataset(d, resolution=res).get_all_images(),
            jdata.TFRecordDataset(d, resolution=res).get_all_images())


def test_both_writers_write_the_same_bytes(tmp_path):
    dj, _, _ = _write(jtool, str(tmp_path / "j"), "toy")
    dt, _, _ = _write(ttool, str(tmp_path / "t"), "toy")
    for name in os.listdir(dj):
        with open(os.path.join(dj, name), "rb") as a, open(os.path.join(dt, name), "rb") as b:
            assert a.read() == b.read(), name
    assert list(ttfr.read_records(os.path.join(dt, "toy-r04.tfrecords"), verify_crc=True))


@pytest.mark.parametrize("data", [b"", b"123456789", b"\x00" * 32, bytes(range(256)) * 3])
def test_crc32c_matches(data):
    assert ttfr.crc32c(data) == jtfr._crc32c_py(data)


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 7)])
def test_minibatch_stream_matches(tmp_path, shuffle, seed):
    d, _, _ = _write(ttool, str(tmp_path), "toy")
    jd = jdata.load_dataset(data_dir=str(tmp_path), tfrecord_dir="toy", shuffle=shuffle,
                            seed=seed, max_label_size="full")
    td = tdata.load_dataset(data_dir=str(tmp_path), tfrecord_dir="toy", shuffle=shuffle,
                            seed=seed, max_label_size="full")
    for mb in (3, 7, 16, 5, 12, 9):
        (ji, jl), (ti, tl) = jd.get_minibatch_np(mb), td.get_minibatch_np(mb)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td.get_random_labels_np(4), jd.get_random_labels_np(4))


def test_prefetcher_delivers_the_inline_stream(tmp_path):
    d, _, _ = _write(ttool, str(tmp_path), "toy")
    inline = tdata.TFRecordDataset(d, shuffle=True, seed=3)
    fetched = tdata.TFRecordDataset(d, shuffle=True, seed=3)
    want = [inline.get_minibatch_np(6) for _ in range(12)]
    p = tdata.Prefetcher(lambda: fetched.get_minibatch_np(6), depth=2)
    try:
        got = [p.get() for _ in range(12)]
    finally:
        p.close()
    for (wi, wl), (gi, gl) in zip(want, got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_prefetcher_raises_the_workers_error():
    def fail():
        raise ValueError("boom")
    p = tdata.Prefetcher(fail, depth=1)
    with pytest.raises(ValueError, match="boom"):
        p.get()
    p.close()


def test_load_celeba_attributes(tmp_path):
    path = tmp_path / "list_attr_celeba.txt"
    path.write_text("2\nMale Young Bald\n000001.jpg  1 -1 -1\n000002.jpg -1  1  1\n\n")
    names, table = ttool.load_celeba_attributes(str(path))
    jnames, jtable = jtool.load_celeba_attributes(str(path))
    assert names == jnames == ["Male", "Young", "Bald"]
    assert table.keys() == jtable.keys()
    np.testing.assert_array_equal(table["000002.jpg"], [0, 1, 1])
    for k in table:
        np.testing.assert_array_equal(table[k], jtable[k])


@pytest.mark.parametrize("args", [
    dict(minibatch_size_base=6, minibatch_gpu_base=6),
    dict(minibatch_size_base=8, minibatch_gpu_base=4, lrate_rampup_kimg=5.0,
         G_lrate_dict={16: 0.001}, tick_kimg_dict={16: 0.5}),
    dict(lod_initial_resolution=4, lod_training_kimg=3, lod_transition_kimg=2,
         minibatch_size_dict={4: 32, 8: 16}, D_lrate_dict={8: 0.003}),
])
@pytest.mark.parametrize("kimg", [0.0, 1.234, 4.5, 7.0, 12.0])
def test_training_schedule_matches(args, kimg):
    nimg = int(kimg * 1000)
    assert dict(tsched.training_schedule(nimg, 4, **args)) == dict(
        jsched.training_schedule(nimg, 4, **args))


@pytest.mark.parametrize("kimg,resume,ramp", [
    (0.0, 0.0, 0.0), (1.0, 0.5, 2.0), (3.0, 0.5, 2.0), (0.2, 0.5, 2.0), (5.0, 5.0, 1.0)])
def test_resume_rampup_scale_matches(kimg, resume, ramp):
    assert tsched.resume_rampup_scale(kimg, resume, ramp) == \
        jsched.resume_rampup_scale(kimg, resume, ramp)
