"""ScanNet-format file IO (host-side).

Counterpart of `e2e_multi_view_matching_tpu/data/scannet.py`: split lists
from `*_{split}.txt`, per-scene `intrinsic/intrinsic_color.txt` (4x4) or
per-image `intrinsic/<id>.txt`, per-image `pose/<id>.txt` (cam->world 4x4),
depth as 16-bit PNG millimetres, color as JPEG. Images are decoded with OpenCV,
as the JAX package decodes them, so both packages read the same pixels.
"""

import os

import cv2
import numpy as np


def get_scenes(data_dir, split):
    split_txt = None
    for f in os.listdir(data_dir):
        if f.endswith(f"_{split}.txt"):
            split_txt = os.path.join(data_dir, f)
    if split_txt is None:
        raise FileNotFoundError(f"no *_{split}.txt split list under {data_dir}")
    with open(split_txt) as f:
        return [line.strip() for line in f if line.strip()]


def read_intrinsics(data_split_dir, scene, id=None, type="intrinsic_color"):
    """Per-scene intrinsics (scannet) or per-image (megadepth/matterport
    layouts); None when the file holds a non-finite value."""
    if id is None:
        path = os.path.join(data_split_dir, scene, "intrinsic", f"{type}.txt")
    else:
        path = os.path.join(data_split_dir, scene, "intrinsic", f"{id}.txt")
    intr = np.loadtxt(path, delimiter=" ")
    if not np.all(np.isfinite(intr)):
        return None
    return intr


def read_pose(data_split_dir, scene, id):
    pose = np.loadtxt(os.path.join(data_split_dir, scene, "pose", f"{id}.txt"), delimiter=" ")
    if not np.all(np.isfinite(pose)):
        return None
    return pose


def _imread(path, flags):
    img = cv2.imread(path, flags)
    if img is None:  # OpenCV returns None for a missing or undecodable file
        raise OSError(f"cannot read image {path}")
    return img


def read_depth(data_split_dir, scene, id):
    """(H, W) float32 metres from the 16-bit millimetre PNG."""
    depth = _imread(os.path.join(data_split_dir, scene, "depth", f"{id}.png"),
                    cv2.IMREAD_UNCHANGED).astype(np.float32)
    return depth / 1000.0


def read_rgb(data_split_dir, scene, id, gray=False):
    """(H, W, 3) uint8 RGB, or (H, W) uint8 gray with `gray`."""
    path = os.path.join(data_split_dir, scene, "color", f"{id}.jpg")
    if gray:
        return _imread(path, cv2.IMREAD_GRAYSCALE)
    return cv2.cvtColor(_imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def resize_intrinsics(K, fact_x, fact_y):
    K = K.copy()
    K[0, 0] *= fact_x
    K[1, 1] *= fact_y
    K[0, 2] *= fact_x
    K[1, 2] *= fact_y
    return K


def crop_intrinsics(K, crop_x, crop_y):
    K = K.copy()
    K[0, 2] -= crop_x
    K[1, 2] -= crop_y
    return K
