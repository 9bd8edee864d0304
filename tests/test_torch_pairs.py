"""The pair benchmark's host side and its bucketed SuperPoint: the port's
`data/pairs.py`, `geom/ransac.py` and `models/superpoint.py` (`valid_size`)
against the JAX package on the CPU, on synthetic pair lists in the three
formats (LoFTR's ScanNet `test.npz` and MegaDepth scene-info npz, SuperGlue's
YFCC txt) and on seeded images and bridged weights."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers side by side: one intra-op thread each keeps
# torch from oversubscribing the cores that XLA compiles on
torch.set_num_threads(1)

from e2e_multi_view_matching_tpu.data import pairs as jpairs  # noqa: E402
from e2e_multi_view_matching_tpu.geom import ransac as jransac  # noqa: E402
from e2e_multi_view_matching_tpu.models import superpoint as jsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data import pairs as tpairs  # noqa: E402
from e2e_multi_view_matching_tpu_torch.data.synthetic import (  # noqa: E402
    SphereFieldScene,
    fourier_texture_image,
    write_scannet_format,
)
from e2e_multi_view_matching_tpu_torch.geom import ransac as transac  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models import superpoint as tsp  # noqa: E402
from e2e_multi_view_matching_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from tests.torch_memory import teardown_module  # noqa: E402,F401


def _random_pose(rng):
    w = rng.normal(size=3) * 0.2
    R, _ = cv2.Rodrigues(w)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    return T


def _intrinsics(rng, h, w):
    return np.array([[rng.uniform(300, 500), 0, w / 2 + rng.normal()],
                     [0, rng.uniform(300, 500), h / 2 + rng.normal()], [0, 0, 1.0]])


def _write_image(path, rng, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(path, rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))


def write_pair_lists(root, n_pairs=6, seed=0):
    """Synthetic pair lists in the three formats under `root`, with their
    images: returns {dataset: (data_dir, [list files])}. ScanNet: a
    `write_scannet_format` tree (96 x 128) and `scannet_test_1500/test.npz`;
    MegaDepth: landscape and portrait JPEGs of three shapes and a scene-info
    npz; YFCC: non-square JPEGs with in-plane rotations 0-3 on both sides."""
    rng = np.random.default_rng(seed)
    out = {}
    scene = SphereFieldScene(rng, n_views=n_pairs + 1, H=96, W=128)
    write_scannet_format(scene, root, scene_name="scene0777_00", split="test",
                         image_fn=fourier_texture_image)
    npz = os.path.join(root, "assets", "scannet_test_1500", "test.npz")
    os.makedirs(os.path.dirname(npz))
    np.savez(npz, name=np.asarray([(777, 0, i, i + 1) for i in range(n_pairs)]))
    out["scannet"] = (os.path.join(root, "scannet"), [npz])

    mega = os.path.join(root, "megadepth")
    shapes = [(120, 160), (160, 120), (90, 150)]
    n_img = n_pairs + 1
    paths = np.empty(n_img, dtype=object)
    intrs, poses = [], []
    for i in range(n_img):
        h, w = shapes[i % len(shapes)]
        paths[i] = f"Undistorted_SfM/0015/images/{i}.jpg"
        _write_image(os.path.join(mega, paths[i]), rng, h, w)
        intrs.append(_intrinsics(rng, h, w))
        poses.append(_random_pose(rng))
    pair_infos = np.empty(n_pairs, dtype=object)
    for i in range(n_pairs):
        pair_infos[i] = (np.array([i, (i + 2) % n_img]), 0.3, np.zeros((0, 2)))
    info = os.path.join(root, "assets", "megadepth_test_1500_scene_info", "0015_0.1_0.3.npz")
    os.makedirs(os.path.dirname(info))
    np.savez(info, image_paths=paths, intrinsics=np.stack(intrs), poses=np.stack(poses),
             pair_infos=pair_infos)
    out["megadepth"] = (mega, [info])

    yfcc = os.path.join(root, "yfcc100m")
    lines = []
    for i in range(n_pairs):
        names = []
        for side in range(2):
            h, w = (100, 140) if (i + side) % 2 else (130, 90)
            names.append(f"scene{i % 2}/images/{i}_{side}.jpg")
            _write_image(os.path.join(yfcc, names[-1]), rng, h, w)
        K0, K1 = _intrinsics(rng, 100, 140), _intrinsics(rng, 130, 90)
        T = _random_pose(rng)
        fields = names + [str(i % 4), str((3 * i + 1) % 4)]
        fields += [repr(float(x)) for x in np.concatenate([K0.ravel(), K1.ravel(), T.ravel()])]
        lines.append(" ".join(fields))
    txt = os.path.join(root, "assets", "yfcc_test_pairs_with_gt.txt")
    with open(txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    out["yfcc100m"] = (yfcc, [txt])
    return out


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return write_pair_lists(str(tmp_path_factory.mktemp("pairs")))


@pytest.mark.parametrize("dataset,img_size", [("scannet", 720), ("megadepth", 1600),
                                              ("megadepth", 150), ("yfcc100m", 1600),
                                              ("yfcc100m", 100)])
def test_pair_dataset_matches_jax(lists, dataset, img_size):
    """Images, intrinsics, T021, ids and scene names equal JAX's bit for bit:
    the rotation before the resize, the truncating resize to the long side,
    OpenCV's resize of float32 gray, the intrinsic and pose fix-ups."""
    data_dir, files = lists[dataset]
    ref = jpairs.PairMatchingDataset(data_dir, files, img_size, dataset)
    ours = tpairs.PairMatchingDataset(data_dir, files, img_size, dataset)
    assert len(ours) == len(ref) == 6
    shapes = set()
    for i in range(len(ref)):
        a, b = ref[i], ours[i]
        assert a.keys() == b.keys()
        for k in ("image0", "image1", "intr0", "intr1", "T021"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["ids"] == b["ids"] and a["scene"] == b["scene"]
        shapes |= {b["image0"].shape, b["image1"].shape}
        assert max(b["image0"].shape) == img_size
    assert len(shapes) >= (1 if dataset == "scannet" else 2)
    if dataset == "scannet" and img_size == 720:
        assert shapes == {(540, 720, 1)}


def test_rotations_match_jax():
    rng = np.random.default_rng(1)
    for rot in range(4):
        K = _intrinsics(rng, 90, 130)
        np.testing.assert_array_equal(jpairs.rotate_intrinsics(K, (90, 130), rot),
                                      tpairs.rotate_intrinsics(K, (90, 130), rot))
        T = _random_pose(rng)
        np.testing.assert_array_equal(jpairs.rotate_pose_inplane(T, rot),
                                      tpairs.rotate_pose_inplane(T, rot))


def test_ransac_matches_jax_and_repeats():
    """Identical matches give the JAX package's pose and inliers exactly, and
    the same again on a second call (OpenCV's RANSAC is deterministic for
    identical inputs); fewer than 5 matches give None."""
    rng = np.random.default_rng(2)
    K0 = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    K1 = np.array([[450.0, 0, 300], [0, 470.0, 250], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-2, 2, (80, 2)), rng.uniform(4, 9, (80, 1))], 1)
    T = _random_pose(rng)
    T[:3, 3] *= 0.3
    x0 = X @ K0.T.astype(np.float64)
    X1 = X @ T[:3, :3].T + T[:3, 3]
    x1 = X1 @ K1.T.astype(np.float64)
    mk0 = (x0[:, :2] / x0[:, 2:]).astype(np.float32)
    mk1 = (x1[:, :2] / x1[:, 2:] + rng.normal(size=(80, 2)) * 0.3).astype(np.float32)
    mk1[:10] = rng.uniform(0, 600, (10, 2))  # outliers
    ref = jransac.estimate_pose_ransac(mk0, mk1, K0, K1)
    ours = transac.estimate_pose_ransac(mk0, mk1, K0, K1)
    again = transac.estimate_pose_ransac(mk0, mk1, K0, K1)
    for a, b, c in zip(ref, ours, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    cos = (np.trace(T[:3, :3].T @ ours[0]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 2.0
    assert transac.mean_focal(K0, K1) == jransac.mean_focal(K0, K1)
    assert transac.estimate_pose_ransac(mk0[:4], mk1[:4], K0, K1) is None


@pytest.fixture(scope="module")
def superpoints():
    cfg = dict(nms_radius=4, keypoint_threshold=1e-4, max_keypoints=64, remove_borders=4,
               fill_with_random_keypoints=False)
    j = jsp.SuperPoint(jsp.SuperPointConfig(**cfg))
    variables = j.init({"params": jax.random.PRNGKey(0), "keypoints": jax.random.PRNGKey(1)},
                       jnp.zeros((1, 64, 64, 1)))
    port = tsp.SuperPoint(tsp.SuperPointConfig(**cfg))
    port.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return j, variables, port.eval()


def _live(out, b):
    """(keypoints, scores, descriptors) of image b's detections, in raster order."""
    k, s, d = (np.asarray(out[n][b]) for n in ("keypoints", "scores", "descriptors"))
    live = s > 0
    order = np.lexsort((k[live][:, 0], k[live][:, 1]))
    return k[live][order], s[live][order], d[live][order]


def test_superpoint_valid_size_matches_jax(superpoints):
    """Two image sizes on one 128 x 128 bucket: the port's bucketed SuperPoint
    against JAX's (keypoints equal, scores and descriptors within 1e-5: the
    f32 convolutions' reduction order), no keypoint in the pad region, and
    inside each extent the exact-size run's detections (as JAX's
    `test_superpoint_valid_size_masks_pad_region`)."""
    j, variables, port = superpoints
    rng = np.random.default_rng(3)
    sizes = [(96, 120), (104, 128)]
    imgs = [rng.uniform(size=(h, w, 1)).astype(np.float32) for h, w in sizes]
    canvas = np.zeros((2, 128, 128, 1), np.float32)
    for b, (h, w) in enumerate(sizes):
        canvas[b, :h, :w] = imgs[b]
    valid = np.asarray(sizes, np.int32)
    ref = jax.jit(j.apply)(variables, jnp.asarray(canvas), jnp.asarray(valid))
    ours = port(torch.from_numpy(canvas), torch.from_numpy(valid))
    for b, (h, w) in enumerate(sizes):
        kr, sr, dr = _live(ref, b)
        ko, so, do = _live({k: v.numpy() for k, v in ours.items()}, b)
        np.testing.assert_array_equal(kr, ko)
        np.testing.assert_allclose(sr, so, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(dr, do, atol=1e-5)
        assert len(ko) > 0 and np.all(ko[:, 0] < w) and np.all(ko[:, 1] < h)
        exact = port(torch.from_numpy(imgs[b][None]))
        ke, se, de = _live({k: v.numpy() for k, v in exact.items()}, 0)
        np.testing.assert_array_equal(ke, ko)
        np.testing.assert_allclose(se, so, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(de, do, atol=1e-5)


def test_superpoint_valid_size_fill_stays_inside(superpoints):
    """With the random fill on, the filled slots lie inside each image's true
    extent (minus the border), never in the pad region."""
    _, variables, _ = superpoints
    cfg = dict(nms_radius=4, keypoint_threshold=0.5, max_keypoints=64, remove_borders=4,
               fill_with_random_keypoints=True)
    port = tsp.SuperPoint(tsp.SuperPointConfig(**cfg))
    port.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    canvas = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(2, 128, 128, 1)).astype(np.float32))
    valid = torch.tensor([[96, 120], [104, 72]])
    out = port.eval()(canvas, valid, generator=torch.Generator().manual_seed(0))
    filled = out["scores"] == 0
    assert bool(filled.all(dim=1).any())
    for b in range(2):
        k = out["keypoints"][b][filled[b]]
        assert bool((k >= 4).all())
        assert bool((k[:, 0] <= valid[b, 1] - 5).all() and (k[:, 1] <= valid[b, 0] - 5).all())
