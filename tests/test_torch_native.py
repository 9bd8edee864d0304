"""The port's native host runtime against the JAX package's (CPU).

The two libraries are built from copies of the same C++ sources with the same
flags, so every comparison is exact: the file readers, the threaded batch
loader, the overlap matrix, the `emvm_overlap` tool's JSON bytes and the
`use_native` samples of `MatchingTupleDataset` (ScanNet, Matterport's per-image
intrinsics, 1296x968 color). `use_native="auto"` resolves as JAX's does; a
failed build makes `use_native=True` raise with the compiler's message; and the
native path's 1296x968 row offset, which the port copies from JAX, is pinned.
Cases that need the JAX package's library skip when it is not built."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import native_loader as jnative  # noqa: E402
from e2e_multi_view_matching_tpu.data import tuples as jtuples  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import native_loader as tnative  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import tuples as ttuples  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "native", "build", "emvm_overlap")
H, W = 96, 128
SAMPLE_KEYS = ("images", "intr", "poses", "depths")
BAND_ROWS = (30.0, 484.0, 938.0)

needs_jax_library = pytest.mark.skipif(not jnative.available(),
                                       reason="the JAX package's native library is not built")


def _color_texture(rng, h, w):
    """Smooth random color (uint8 BGR, h x w) with some fine detail."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        k = rng.normal(size=2) * 0.15
        img[..., c] = 127 + 100 * np.sin(k[0] * xx + k[1] * yy + rng.uniform(0, 6))
    img += rng.normal(size=img.shape) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_tree(root, dataset="scannet", **kwargs):
    """Two train scenes of 6 views (the second with 120x160 color JPEGs) and a
    test scene of 5, seeded; returns the dataset directory."""
    rng = np.random.default_rng(0)
    for cls, split, name in ((tsyn.SphereFieldScene, "train", "scene0000_00"),
                             (tsyn.PlaneScene, "train", "scene0001_00"),
                             (tsyn.PlaneScene, "test", "scene0707_00")):
        scene = cls(rng, n_views=6 if split == "train" else 5, H=H, W=W)
        tsyn.write_scannet_format(scene, root, scene_name=name, split=split, dataset=dataset,
                                  image_fn=tsyn.fourier_texture_image, **kwargs)
    ds = os.path.join(root, dataset)
    color = os.path.join(ds, "scans", "scene0001_00", "color")
    for f in sorted(os.listdir(color)):
        assert cv2.imwrite(os.path.join(color, f), _color_texture(rng, 120, 160))
    return ds


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("native_tree")))


def _scene_files(tree, scene, ids):
    sdir = os.path.join(tree, "scans", scene)
    return ([os.path.join(sdir, "color", f"{i}.jpg") for i in ids],
            [os.path.join(sdir, "depth", f"{i}.png") for i in ids])


def _assert_same_sample(a, b):
    assert a["scene"] == b["scene"] and a["ids"] == b["ids"]
    for k in SAMPLE_KEYS:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@needs_jax_library
@pytest.mark.parametrize("case", ["gray", "gray_resized", "depth", "depth_resized", "sizes"])
def test_file_readers_match_jax(tree, case):
    """One file at a time: grayscale JPEG decode (libjpeg's RGB -> luma on a
    color file) at its own size and bilinearly resized, the 16-bit depth PNG
    at its own size and nearest-resized, and the header sizes."""
    (rgb,), (depth,) = _scene_files(tree, "scene0001_00", [2])
    if case == "sizes":
        assert tnative.jpeg_size(rgb) == jnative.jpeg_size(rgb) == (120, 160)
        assert tnative.png_size(depth) == jnative.png_size(depth) == (H, W)
        return
    fn, path, shape = {"gray": ("load_gray", rgb, (120, 160)),
                       "gray_resized": ("load_gray", rgb, (H, W)),
                       "depth": ("load_depth", depth, (H, W)),
                       "depth_resized": ("load_depth", depth, (61, 83))}[case]
    ours, ref = getattr(tnative, fn)(path, *shape), getattr(jnative, fn)(path, *shape)
    assert ours.shape == shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert np.ptp(ours) > 0.1


@needs_jax_library
@pytest.mark.parametrize("n_threads", [0, 1, 4])
def test_load_batch_matches_jax(tree, n_threads):
    """The threaded batch of a scene's six views at the depth size, equal to
    JAX's and to one file at a time; a missing file raises IOError."""
    rgb, depth = _scene_files(tree, "scene0001_00", range(6))
    images, depths = tnative.load_batch(rgb, depth, H, W, n_threads=n_threads)
    ref_images, ref_depths = jnative.load_batch(rgb, depth, H, W, n_threads=n_threads)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(depths, ref_depths)
    np.testing.assert_array_equal(images[3], tnative.load_gray(rgb[3], H, W))
    with pytest.raises(IOError, match="1 of 2"):
        tnative.load_batch([rgb[0], rgb[0] + ".missing"], depth[:2], H, W, n_threads=n_threads)


@needs_jax_library
@pytest.mark.parametrize("stride", [8, 3])
def test_overlap_matrix_matches_jax(stride):
    """The overlap matrix of six views of a plane, on 8 threads and on one."""
    scene = tsyn.PlaneScene(np.random.default_rng(1), n_views=6, H=H, W=W)
    depths = np.stack([scene.depth_map(v) for v in range(6)])
    ours = tnative.overlap_matrix(depths, scene.poses, scene.intr, stride=stride)
    np.testing.assert_array_equal(
        ours, jnative.overlap_matrix(depths, scene.poses, scene.intr, stride=stride))
    np.testing.assert_array_equal(
        ours, tnative.overlap_matrix(depths, scene.poses, scene.intr, stride=stride,
                                     n_threads=1))
    np.testing.assert_array_equal(ours, ours.T)
    assert ours[0, 1] > 0.2 and np.all(np.diag(ours) == 0)


@needs_jax_library
@pytest.mark.skipif(not os.path.exists(JAX_TOOL), reason="the JAX package's tool is not built")
def test_overlap_tool_writes_the_jax_tools_json(tree, tmp_path):
    """`emvm_overlap` of the port and of the JAX package, each on its own copy
    of the tree, write the same bytes, one JSON per scene of the split, and
    the port's tuple sampler reads them."""
    outs = {}
    for name, tool in (("port", tnative.overlap_tool()), ("jax", JAX_TOOL)):
        copy = str(tmp_path / name)
        shutil.copytree(tree, copy)
        shutil.rmtree(os.path.join(copy, "overlap"))
        run = subprocess.run([tool, copy, "train", "0.2", "1.0", "8"], capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        odir = os.path.join(copy, "overlap", "scans")
        outs[name] = {f: open(os.path.join(odir, f), "rb").read() for f in os.listdir(odir)}
    assert tnative.overlap_tool().startswith(os.path.join(ROOT, "build", "native", ""))
    assert sorted(outs["port"]) == ["scene0000_00.json", "scene0001_00.json"]
    assert outs["port"] == outs["jax"]
    graph = json.loads(outs["port"]["scene0001_00.json"])
    assert sorted(map(int, graph)) == list(range(6)) and any(graph.values())
    ds = ttuples.MatchingTupleDataset(str(tmp_path / "port"), "train", 3, n_samples=2)
    assert len(ds) > 0 and ds.use_native


def _large_color(scans, scene, rng, bands=False):
    """Rewrite the color of `scans/scene` as 1296x968 JPEGs: textured, or
    black with white Gaussian bands (sigma 5 rows) centred on source rows
    30, 484 and 938."""
    color = os.path.join(scans, scene, "color")
    for f in sorted(os.listdir(color)):
        if bands:
            rows = np.arange(968.0)[:, None, None]
            profile = sum(np.exp(-0.5 * ((rows - c) / 5.0) ** 2) for c in BAND_ROWS)
            img = np.broadcast_to(255 * profile, (968, 1296, 3)).round().astype(np.uint8)
        else:
            img = cv2.resize(_color_texture(rng, 121, 162), (1296, 968))
        assert cv2.imwrite(os.path.join(color, f), img)


@needs_jax_library
@pytest.mark.parametrize("layout", ["scannet", "matterport", "scannet_1296x968"])
def test_native_samples_match_jax(tmp_path, layout):
    """`use_native=True` samples of the port and of JAX, equal to the bit:
    scene intrinsics, Matterport's per-image ones (cx + 0.5 id) and 1296x968
    color over 96x128 depth (the intrinsics of a 972-row frame); and a batch."""
    dataset = "matterport" if layout == "matterport" else "scannet"
    root = _write_tree(str(tmp_path), dataset=dataset, per_image_intr_cx_step=0.5)
    if layout == "scannet_1296x968":
        _large_color(os.path.join(root, "scans"), "scene0000_00", np.random.default_rng(2))
    jds = jtuples.MatchingTupleDataset(root, "train", 3, n_samples=3, seed=3, use_native=True)
    tds = ttuples.MatchingTupleDataset(root, "train", 3, n_samples=3, seed=3, use_native=True)
    assert tds.use_native and tds.sampled_tuples == jds.sampled_tuples and len(tds) == 6
    for i in range(len(tds)):
        b = tds[i]
        _assert_same_sample(jds[i], b)
        assert b["images"].shape == (3, H, W, 1) and b["depths"].shape == (3, H, W)
    if layout == "matterport":  # scene0000_00's color is at the depth size
        b = tds[next(i for i, (s, _) in enumerate(tds.sampled_tuples) if s == "scene0000_00")]
        cx = np.loadtxt(os.path.join(root, "scans", b["scene"], "intrinsic", "0.txt"))[0, 2]
        np.testing.assert_allclose(b["intr"][:, 0, 2], cx + 0.5 * np.asarray(b["ids"]),
                                   atol=1e-5)
    if layout == "scannet_1296x968":
        b = tds[next(i for i, (s, _) in enumerate(tds.sampled_tuples) if s == "scene0000_00")]
        intr = np.loadtxt(os.path.join(root, "scans", "scene0000_00", "intrinsic",
                                       "intrinsic_color.txt"))
        np.testing.assert_allclose(b["intr"][0, 1, 2], (intr[1, 2] + 2) * H / 972, rtol=1e-6)
        np.testing.assert_allclose(b["intr"][0, 0, 0], intr[0, 0] * W / 1296, rtol=1e-6)
    ref = list(jtuples.batch_iterator(jds, 2, shuffle=True, seed=1))
    ours = list(ttuples.batch_iterator(tds, 2, shuffle=True, seed=1))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ref, ours):
        assert a["ids"] == b["ids"]
        for k in SAMPLE_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["plain", "jitter", "megadepth"])
def test_auto_resolves_as_jax(tmp_path, case):
    """`use_native="auto"` is native exactly when JAX's is: when the library
    is there, without the color jitter and outside a MegaDepth tree."""
    root = _write_tree(str(tmp_path), dataset="megadepth" if case == "megadepth" else "scannet")
    kw = dict(n_samples=2, jitter=0.2 if case == "jitter" else None)
    jds = jtuples.MatchingTupleDataset(root, "train", 3, **kw)
    tds = ttuples.MatchingTupleDataset(root, "train", 3, **kw)
    assert tds.use_native == (case == "plain") and tnative.available()
    if jnative.available():
        assert jds.use_native == tds.use_native


def test_use_native_raises_when_the_build_fails(tree, tmp_path, monkeypatch):
    """With a compiler that does not exist and nothing built, `available()`
    is False, `auto` takes the Python path, and `use_native=True` raises at
    the first sample with the compiler's failure, as the JAX package does
    without its library; the failure is kept, not retried."""
    missing = str(tmp_path / "no-such-c++")
    monkeypatch.setenv("CXX", missing)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    for name in ("_lib", "_tool", "_error"):
        monkeypatch.setattr(tnative, name, None)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    assert not tnative.available() and not jnative.available()
    for mod in (ttuples, jtuples):
        assert not mod.MatchingTupleDataset(tree, "train", 3, n_samples=2).use_native
        ds = mod.MatchingTupleDataset(tree, "train", 3, n_samples=2, use_native=True)
        with pytest.raises(RuntimeError, match="no-such-c\\+\\+" if mod is ttuples else "not built"):
            ds[0]
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        tnative.overlap_tool()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [".lock"]


def _band_centroids(image, centres, half=8):
    """Row centroids of the bright bands of a (rows, cols) image near each of
    `centres` (output rows), from the column-mean profile."""
    profile = image.mean(axis=1)
    out = []
    for c in centres:
        rows = np.arange(int(round(c)) - half, int(round(c)) + half + 1)
        w = profile[rows] - profile[rows].min()
        out.append(float((rows * w).sum() / w.sum()))
    return np.array(out)


@needs_jax_library
def test_native_1296x968_rows_are_offset_as_in_jax(tmp_path):
    """The reference's native path sets the intrinsics of a 972-row padded
    frame but resizes the unpadded 968 rows; the Python path pads. On 480x640
    depth, bands at source rows 30, 484 and 938 land 0.925 rows lower on the
    Python path near the top, 0.927 rows higher near the bottom and at the
    same row at mid-height: the Python path maps source row s to (s + 2.5)
    480 / 972 - 0.5, the native one to (s + 0.5) 480 / 968 - 0.5. The port's
    samples equal JAX's on both paths, so both carry the offset."""
    rng = np.random.default_rng(0)
    scene = tsyn.PlaneScene(rng, n_views=2, H=480, W=640, f=577.0)
    root = tsyn.write_scannet_format(scene, str(tmp_path), split="test")
    _large_color(os.path.join(root, "scans_test"), "scene0000_00", rng, bands=True)
    samples = {}
    for native in (False, True):
        jds = jtuples.MatchingTupleDataset(root, "test", 2, n_samples=1, use_native=native)
        tds = ttuples.MatchingTupleDataset(root, "test", 2, n_samples=1, use_native=native)
        a, b = jds[0], tds[0]
        _assert_same_sample(a, b)
        samples[native] = b
    np.testing.assert_array_equal(samples[True]["intr"], samples[False]["intr"])
    src = np.array(BAND_ROWS)
    python_rows = (src + 2.5) * 480 / 972 - 0.5
    native_rows = (src + 0.5) * 480 / 968 - 0.5
    np.testing.assert_allclose(python_rows - native_rows, [0.925, -0.001, -0.927], atol=1e-3)
    for v in range(2):
        py = _band_centroids(samples[False]["images"][v, ..., 0], python_rows)
        nat = _band_centroids(samples[True]["images"][v, ..., 0], native_rows)
        np.testing.assert_allclose(py, python_rows, atol=0.02)
        np.testing.assert_allclose(nat, native_rows, atol=0.02)
        np.testing.assert_allclose(py - nat, python_rows - native_rows, atol=0.01)
