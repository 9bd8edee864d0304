"""The port's ScanNet readers against the JAX package's (CPU): the same trees,
tuples, samples and batches.

Both packages decode with OpenCV, so every comparison is exact: tuple lists,
images (with and without the color jitter), intrinsics, poses, depths, the
fixed-tuple CSV and the batch order. Both packages' datasets run with
`use_native=False`, the Python path; their native paths are compared in
`test_torch_native.py`."""

import filecmp
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import sampling as jsampling  # noqa: E402
from e2e_multi_view_matching_tpu.data import synthetic as jsyn  # noqa: E402
from e2e_multi_view_matching_tpu.data import tuples as jtuples  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import sampling as tsampling  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import scannet as tscannet  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import tuples as ttuples  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

H, W = 96, 128
SAMPLE_KEYS = ("images", "intr", "poses", "depths")


def _write_tree(syn, root, dataset="scannet", **kwargs):
    """Two train scenes of 6 views and one test scene of 5, seeded."""
    rng = np.random.default_rng(0)
    scenes = [(syn.SphereFieldScene, "train", "scene0000_00", syn.fourier_texture_image),
              (syn.MultiPlaneScene, "train", "scene0001_00", syn.multiplane_image),
              (syn.PlaneScene, "test", "scene0707_00", syn.checkerboard_image)]
    for cls, split, name, image_fn in scenes:
        scene = cls(rng, n_views=6 if split == "train" else 5, H=H, W=W)
        syn.write_scannet_format(scene, root, scene_name=name, split=split,
                                 dataset=dataset, image_fn=image_fn, **kwargs)
    return os.path.join(root, dataset)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seeded scenes written by each package's writer."""
    out = {}
    for name, syn in (("jax", jsyn), ("torch", tsyn)):
        out[name] = _write_tree(syn, str(tmp_path_factory.mktemp(f"tree_{name}")))
    return out


def _datasets(root, split="train", **kwargs):
    return (jtuples.MatchingTupleDataset(root, split, use_native=False, **kwargs),
            ttuples.MatchingTupleDataset(root, split, use_native=False, **kwargs))


def _assert_same_sample(a, b):
    assert a["scene"] == b["scene"] and a["ids"] == b["ids"]
    for k in SAMPLE_KEYS:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_writers_write_the_same_tree(trees):
    """Every file of the port's tree (split lists, overlap JSON, intrinsics,
    poses, 16-bit depth PNGs, JPEGs) equals the JAX writer's, byte for byte."""
    a, b = trees["jax"], trees["torch"]
    assert _files(a) == _files(b) and len(_files(a)) == 59
    _, mismatch, errors = filecmp.cmpfiles(a, b, _files(a), shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("jitter", [None, 0.2])
def test_tuples_and_samples_match_jax(trees, writer, jitter):
    """On either package's tree: the same tuples after construction and after
    `start_epoch()`, and the same samples, with and without the jitter."""
    jds, tds = _datasets(trees[writer], tuple_size=3, n_samples=4, jitter=jitter, seed=5)
    for epoch in range(2):
        if epoch:
            jds.start_epoch()
            tds.start_epoch()
        assert len(tds) == 8 and tds.sampled_tuples == jds.sampled_tuples
        assert tds.exclude_set == jds.exclude_set and tds.scenes == jds.scenes
        for i in (0, 5):
            a, b = jds[i], tds[i]
            _assert_same_sample(a, b)
            assert b["images"].shape == (3, H, W, 1) and b["intr"].shape == (3, 4, 4)
    if jitter:
        plain = ttuples.MatchingTupleDataset(trees[writer], "train", tuple_size=3,
                                             n_samples=4, seed=5, use_native=False)
        plain.sampled_tuples = tds.sampled_tuples
        plain.epoch = tds.epoch
        assert not np.array_equal(plain[0]["images"], tds[0]["images"])


def test_scene_without_enough_tuples_is_excluded(tmp_path):
    """A scene whose overlap graph cannot give a tuple lands in the exclude set
    of both packages, drawn with the same generator."""
    root = _write_tree(tsyn, str(tmp_path))
    overlap = os.path.join(root, "overlap", "scans", "scene0001_00.json")
    with open(overlap, "w") as f:  # views 0 and 1 only see each other
        f.write('{"0": [1], "1": [0], "2": [0], "3": [1], "4": [0], "5": [1]}')
    jds, tds = _datasets(root, tuple_size=3, n_samples=2, seed=1)
    assert tds.exclude_set == jds.exclude_set == {"scene0001_00"}
    assert tds.scenes == jds.scenes == ["scene0000_00"]
    assert tds.sampled_tuples == jds.sampled_tuples


def test_matterport_per_image_intrinsics(tmp_path):
    """The Matterport layout reads `intrinsic/<id>.txt` (cx offset by 0.5 *
    id): the same samples as JAX, and each view's own cx."""
    root = _write_tree(tsyn, str(tmp_path), dataset="matterport",
                       per_image_intr_cx_step=0.5)
    jds, tds = _datasets(root, tuple_size=2, n_samples=3, seed=2)
    assert tds.sampled_tuples == jds.sampled_tuples
    for i in range(len(tds)):
        a, b = jds[i], tds[i]
        _assert_same_sample(a, b)
        cx = np.loadtxt(os.path.join(root, "scans", b["scene"], "intrinsic", "0.txt"))[0, 2]
        np.testing.assert_allclose(b["intr"][:, 0, 2], cx + 0.5 * np.asarray(b["ids"]),
                                   atol=1e-5)


def test_large_scannet_frame_is_padded_and_resized(tmp_path):
    """1296x968 color frames over 96x128 depth maps: both packages pad to 972
    rows (cy + 2), resize to the depth size and rescale the intrinsics, with
    and without the jitter."""
    root = _write_tree(tsyn, str(tmp_path))
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:968, 0:1296].astype(np.float32)
    color = os.path.join(root, "scans", "scene0000_00", "color")
    for f in os.listdir(color):
        img = np.zeros((968, 1296, 3), np.float32)
        for c in range(3):
            k = rng.normal(size=2) * 0.02
            img[..., c] = 127 + 120 * np.sin(k[0] * xx + k[1] * yy + rng.uniform(0, 6))
        cv2.imwrite(os.path.join(color, f), img.astype(np.uint8))
    intr = np.loadtxt(os.path.join(root, "scans", "scene0000_00", "intrinsic",
                                   "intrinsic_color.txt"))
    for jitter in (None, 0.2):
        jds, tds = _datasets(root, tuple_size=2, n_samples=2, jitter=jitter, seed=4)
        assert tds.sampled_tuples == jds.sampled_tuples
        i = next(i for i, (s, _) in enumerate(tds.sampled_tuples) if s == "scene0000_00")
        a, b = jds[i], tds[i]
        _assert_same_sample(a, b)
        assert b["images"].shape == (2, H, W, 1)
        np.testing.assert_allclose(b["intr"][0, 1, 2], (intr[1, 2] + 2) * H / 972, rtol=1e-6)
        np.testing.assert_allclose(b["intr"][0, 0, 0], intr[0, 0] * W / 1296, rtol=1e-6)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("shape", [(60, 80), (80, 60)])
def test_megadepth_square_crop_matches_jax(trees, center, shape):
    """The megadepth square crop (random at train, centred at test) and its
    intrinsics shift, from the same generator state."""
    jds, tds = _datasets(trees["torch"], tuple_size=3, n_samples=1)
    rgb = np.random.default_rng(0).uniform(size=shape + (3,)).astype(np.float32)
    depth = rgb[..., 0] * 5
    intr = np.diag([100.0, 100.0, 1.0, 1.0]).astype(np.float32)
    intr[:2, 2] = (shape[1] / 2, shape[0] / 2)
    a = jds._crop_square(rgb, depth, intr, center, np.random.default_rng(9))
    b = tds._crop_square(rgb, depth, intr, center, np.random.default_rng(9))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert b[0].shape[:2] == (min(shape),) * 2


def test_fixed_tuple_csv_round_trips_both_ways(trees, tmp_path):
    jds, tds = _datasets(trees["torch"], split="test", tuple_size=5, n_samples=3,
                         shuffle_tuple=False)
    tds.write_sampled_tuples(str(tmp_path / "port.csv"), n=2)
    jds.write_sampled_tuples(str(tmp_path / "jax.csv"), n=2)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    jds.read_sampled_tuples(str(tmp_path / "port.csv"))
    tds.read_sampled_tuples(str(tmp_path / "jax.csv"))
    assert tds.sampled_tuples == jds.sampled_tuples and len(tds) == 2
    _assert_same_sample(jds[1], tds[1])


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=3, shuffle=True, seed=3),
    dict(batch_size=3, shuffle=False, drop_last=False),
    dict(batch_size=2, shuffle=False, indices=np.arange(2, 7)),
    dict(batch_size=4, shuffle=True, seed=1, process_index=0, process_count=2),
    dict(batch_size=4, shuffle=True, seed=1, process_index=1, process_count=2),
])
def test_batch_iterator_matches_jax(trees, kwargs):
    """The same batches in the same order, including the short last batch,
    an index subset and each process's slice of a global batch."""
    jds, tds = _datasets(trees["torch"], tuple_size=3, n_samples=4, jitter=0.2)
    jkw = dict(kwargs, indices=kwargs["indices"].copy()) if "indices" in kwargs else kwargs
    ref = list(jtuples.batch_iterator(jds, **jkw))
    ours = list(ttuples.batch_iterator(tds, **kwargs))
    assert len(ours) == len(ref) >= 1
    for a, b in zip(ref, ours):
        assert a["scene"] == b["scene"] and a["ids"] == b["ids"]
        for k in SAMPLE_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batch_iterator_raises_load_errors_and_stops_when_abandoned():
    """A sample that fails to load raises in the consumer (it does not hang
    the loop); a consumer that stops early ends the loading thread."""

    class Failing(torch.utils.data.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise OSError("cannot read image x.jpg")
            return {"scene": "s", "ids": [i], "images": np.zeros((1, 2, 2, 1)),
                    "intr": np.eye(4)[None], "poses": np.eye(4)[None],
                    "depths": np.zeros((1, 2, 2))}

    it = ttuples.batch_iterator(Failing(), 2, shuffle=False)
    assert next(it)["ids"] == [[0], [1]]
    with pytest.raises(OSError, match="x.jpg"):
        list(it)
    before = threading.active_count()
    it = ttuples.batch_iterator(Failing(), 1, shuffle=False, prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() <= before


def test_missing_image_raises(trees):
    with pytest.raises(OSError, match="cannot read image"):
        tscannet.read_rgb(os.path.join(trees["torch"], "scans"), "scene0000_00", 99)


@pytest.mark.parametrize("count,at_least", [(107, 25), (8, 60000), (60001, 60000),
                                            (180000, 60000), (5, 2)])
def test_sequential_subsets_match_jax(count, at_least):
    assert (tsampling.compute_samples_per_subset(count, at_least)
            == jsampling.compute_samples_per_subset(count, at_least))
    ours = tsampling.create_sequential_subsets(count, at_least)
    ref = jsampling.create_sequential_subsets(count, at_least)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(ours), np.arange(count))
