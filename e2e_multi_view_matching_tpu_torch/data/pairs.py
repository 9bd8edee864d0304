"""Two-view evaluation pair lists (host-side).

Counterpart of `e2e_multi_view_matching_tpu/data/pairs.py`, the same
arithmetic on numpy and OpenCV, so that both packages give the same samples
bit for bit:
- megadepth: LoFTR scene-info npz (`pair_infos`, `image_paths`, `intrinsics`,
  `poses`);
- yfcc100m: SuperGlue txt with k x 90 deg in-plane rotations and the
  intrinsic and pose fix-ups;
- scannet: LoFTR `test.npz` names, poses and intrinsics from the ScanNet
  files (`data/scannet.py`).
Images are read as gray, rotated (`np.rot90`) before an aspect-preserving
resize of float32 pixels to the target long side (`int(ar * img_size)`
truncates: ScanNet's 1296 x 968 becomes 537 x 720), and the intrinsics
follow.
"""

import os

import cv2
import numpy as np

from e2e_multi_view_matching_tpu_torch.data.scannet import (
    _imread,
    read_intrinsics,
    read_pose,
    resize_intrinsics,
)


def rotate_intrinsics(K, image_shape, rot):
    """Intrinsics after a k x 90 deg CCW in-plane rotation of an image of
    `image_shape` (the SuperGlue utils' convention)."""
    assert rot <= 3
    h, w = image_shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rot = rot % 4
    if rot == 1:
        return np.array([[fy, 0.0, cy], [0.0, fx, w - 1 - cx], [0.0, 0.0, 1.0]])
    if rot == 2:
        return np.array([[fx, 0.0, w - 1 - cx], [0.0, fy, h - 1 - cy], [0.0, 0.0, 1.0]])
    if rot == 3:
        return np.array([[fy, 0.0, h - 1 - cy], [0.0, fx, cx], [0.0, 0.0, 1.0]])
    return K


def rotate_pose_inplane(T, rot):
    """A k x 90 deg in-plane rotation composed onto a pose (SuperGlue utils)."""
    rot = rot % 4
    a = np.deg2rad(90.0 * rot)
    R_z = np.array([
        [np.cos(a), -np.sin(a), 0.0, 0.0],
        [np.sin(a), np.cos(a), 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return R_z @ T


class PairMatchingDataset:
    """Fixed two-view evaluation pairs with GT relative poses.

    `dataset[i]` is {"image0", "image1" (H, W, 1) float32 in [0, 1], "intr0",
    "intr1" (3|4, 3|4) float32, "T021" (4, 4) float32, "ids", "scene"}.
    """

    def __init__(self, data_dir, input_files, img_size, dataset):
        self.data_dir = data_dir
        self.img_size = img_size
        self.rgb_paths = []
        self.scenes = []
        self.ids = []
        self.intrinsics = []
        self.rots = []
        self.T021s = []
        for f_id, f in enumerate(input_files):
            if dataset == "megadepth":
                data = np.load(f, allow_pickle=True)
                paths = data["image_paths"]
                intrs = data["intrinsics"]
                extrs = data["poses"]
                for pair, _, _ in data["pair_infos"]:
                    id0, id1 = int(pair[0]), int(pair[1])
                    self.rgb_paths.append(
                        (os.path.join(data_dir, paths[id0]), os.path.join(data_dir, paths[id1])))
                    self.intrinsics.append((intrs[id0].copy(), intrs[id1].copy()))
                    self.T021s.append(extrs[id1] @ np.linalg.inv(extrs[id0]))
                    self.rots.append((0, 0))
                    self.scenes.append(f"mega{f_id}")
                    self.ids.append((id0, id1))
            elif dataset == "yfcc100m":
                with open(f) as in_f:
                    pairs = [line.split() for line in in_f.readlines()]
                for i, pair in enumerate(pairs):
                    path0, path1 = pair[:2]
                    rot0, rot1 = int(pair[2]), int(pair[3])
                    intr0 = np.asarray(pair[4:13], float).reshape(3, 3)
                    intr1 = np.asarray(pair[13:22], float).reshape(3, 3)
                    T = np.asarray(pair[22:], float).reshape(4, 4)
                    self.rgb_paths.append(
                        (os.path.join(data_dir, path0), os.path.join(data_dir, path1)))
                    self.intrinsics.append((intr0, intr1))
                    self.T021s.append(T)
                    self.rots.append((rot0, rot1))
                    self.scenes.append("yfcc100m")
                    self.ids.append((i, 2 * i))
            elif dataset == "scannet":
                data = np.load(f)
                split_dir = os.path.join(data_dir, "scans_test")
                for scene, _, id0, id1 in data["name"]:
                    scene_str = f"scene0{scene}_00"
                    sdir = os.path.join(split_dir, scene_str)
                    self.rgb_paths.append((os.path.join(sdir, "color", f"{id0}.jpg"),
                                           os.path.join(sdir, "color", f"{id1}.jpg")))
                    intr = read_intrinsics(split_dir, scene_str)
                    self.intrinsics.append((intr, intr.copy()))
                    pose0 = read_pose(split_dir, scene_str, id0)
                    pose1 = read_pose(split_dir, scene_str, id1)
                    self.T021s.append(np.linalg.inv(pose1) @ pose0)
                    self.rots.append((0, 0))
                    self.scenes.append(scene_str)
                    self.ids.append((int(id0), int(id1)))
            else:
                raise ValueError(f"unknown pair dataset {dataset}")

    def __len__(self):
        return len(self.rgb_paths)

    def __getitem__(self, index):
        data = {}
        for id in range(2):
            img = _imread(self.rgb_paths[index][id], cv2.IMREAD_GRAYSCALE).astype(np.float32)
            rot = self.rots[index][id]
            intr = self.intrinsics[index][id]
            if rot != 0:
                img = np.rot90(img, k=rot)
                intr = rotate_intrinsics(intr, img.shape, rot)
            if self.img_size != max(img.shape):
                if img.shape[0] >= img.shape[1]:
                    ar = img.shape[1] / img.shape[0]
                    size = (self.img_size, int(ar * self.img_size))
                else:
                    ar = img.shape[0] / img.shape[1]
                    size = (int(ar * self.img_size), self.img_size)
                fx, fy = size[1] / img.shape[1], size[0] / img.shape[0]
                intr = resize_intrinsics(np.asarray(intr, float), fx, fy)
                img = cv2.resize(img, (size[1], size[0]))
            data[f"image{id}"] = (img / 255.0)[..., None].astype(np.float32)
            data[f"intr{id}"] = np.asarray(intr, np.float32)
        T021 = self.T021s[index]
        rot0, rot1 = self.rots[index]
        if rot0 != 0 or rot1 != 0:
            cam0 = rotate_pose_inplane(np.eye(4), rot0) if rot0 else np.eye(4)
            cam1 = rotate_pose_inplane(T021, rot1) if rot1 else T021
            T021 = cam1 @ np.linalg.inv(cam0)
        data["T021"] = np.asarray(T021, np.float32)
        data["ids"] = list(self.ids[index])
        data["scene"] = self.scenes[index]
        return data
