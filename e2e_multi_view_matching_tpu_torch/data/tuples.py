"""Tuple dataset: per-epoch stochastic tuple sampling and sample loading (host-side).

Counterpart of `e2e_multi_view_matching_tpu/data/tuples.py`, whose samples
and batches it gives bit for bit:
- a per-scene overlap JSON `{img_id: [candidate ids]}` drives a random walk
  (`_make_tuple`) with retries and a scene exclude set; every draw of tuple
  sampling comes from one `np.random.default_rng(seed)`, and `start_epoch()`
  resamples all tuples;
- `__getitem__` reads intrinsics (per scene for scannet, per image for
  megadepth and matterport), the cam->world pose, depth and RGB; pads
  1296x968 scannet frames to 972 rows (cy + 2), resizes RGB to the depth
  map's size with the intrinsics rescaled, square-crops megadepth (random at
  train, centred at test) and applies one color jitter to all views of a
  tuple. Per-item randomness comes from `_item_rng(index)`, a function of
  (seed, epoch, index) alone;
- fixed test tuples round-trip through the `scene,"[id,...]"` CSV;
- `use_native` ("auto": when the native runtime builds, the tree is not
  MegaDepth and there is no jitter) decodes a tuple's JPEGs and PNGs with the
  C++ runtime of `data/native_loader.py`, on threads, straight to grayscale at
  the depth map's size (`_getitem_native`), as the JAX package does when its
  library is built. For a 1296x968 color frame it sets the intrinsics as if
  the frame had been padded to 972 rows but resizes the unpadded 968 rows, as
  JAX's native path does: those images sit up to about one row (at 480 rows)
  off their own intrinsics near the top and bottom, against the Python path.

`batch_iterator` stacks samples into numpy batches for the train step:
images (B, V, H, W, 1), intr (B, V, 4, 4), poses (B, V, 4, 4),
depths (B, V, H, W), loaded ahead of the consumer by a pool of threads.
"""

import csv
import json
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch

from e2e_multi_view_matching_tpu_torch.data import native_loader
from e2e_multi_view_matching_tpu_torch.data.scannet import (
    crop_intrinsics,
    get_scenes,
    read_depth,
    read_intrinsics,
    read_pose,
    read_rgb,
    resize_intrinsics,
)


def _rgb_to_gray(rgb):
    """ITU-R 601 luma, as torchvision's `rgb_to_grayscale`."""
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


def _color_jitter_params(rng, jitter):
    """Jitter parameters shared by the views of one tuple."""
    order = rng.permutation(4)
    return {
        "order": order,
        "brightness": rng.uniform(1 - jitter, 1 + jitter),
        "contrast": rng.uniform(1 - jitter, 1 + jitter),
        "saturation": rng.uniform(1 - jitter, 1 + jitter),
        "hue": rng.uniform(-jitter, jitter),
    }


def _apply_color_jitter(rgb, p):
    """Brightness, contrast, saturation and hue in the sampled order on
    float32 RGB in [0, 1], (H, W, 3); the hue shift goes through OpenCV's
    8-bit HSV (H in [0, 180))."""
    for fn_id in p["order"]:
        if fn_id == 0:
            rgb = np.clip(rgb * p["brightness"], 0, 1)
        elif fn_id == 1:
            mean = _rgb_to_gray(rgb).mean()
            rgb = np.clip((rgb - mean) * p["contrast"] + mean, 0, 1)
        elif fn_id == 2:
            gray = _rgb_to_gray(rgb)[..., None]
            rgb = np.clip((rgb - gray) * p["saturation"] + gray, 0, 1)
        elif fn_id == 3:
            hsv = cv2.cvtColor((rgb * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
            h = hsv[..., 0].astype(np.int32) + int(p["hue"] * 180)
            hsv[..., 0] = np.mod(h, 180).astype(np.uint8)
            rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0
    return rgb


class MatchingTupleDataset(torch.utils.data.Dataset):
    """Stochastically sampled view tuples from a ScanNet-format tree."""

    def __init__(self, data_dir, split, tuple_size, n_samples=None, jitter=None,
                 shuffle_tuple=True, seed=0, use_native="auto"):
        self.data_dir = data_dir
        self.split = split
        # the native decode has no color jitter and reads scannet-style PNGs
        if use_native == "auto":
            use_native = (jitter is None and "megadepth" not in data_dir
                          and native_loader.available())
        self.use_native = bool(use_native)
        self.data_split_dir = os.path.join(
            data_dir, "scans" + ("_test" if split == "test" else "")
        )
        self.scenes = get_scenes(data_dir, split)
        if "megadepth" in self.data_split_dir:
            self.scenes = [str(s).zfill(4) for s in self.scenes]
        self.tuple_size = tuple_size
        self.shuffle_tuple = shuffle_tuple
        self.n_samples = n_samples
        self.jitter = jitter
        self.exclude_set = set()
        # `self.rng` drives tuple sampling only, so every process that builds
        # the dataset from one seed agrees on the tuple list; per-item draws
        # (jitter, crops) use `_item_rng`, which does not depend on the order
        # or the thread that loads the items
        self.seed = seed
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self.sampled_tuples = []
        self.start_epoch(make_exclude_set=True, _first=True)
        self.scenes = [s for s in self.scenes if s not in self.exclude_set]

    # -- tuple sampling ----------------------------------------------------
    def _make_tuple(self, start_key, candidates):
        """Random walk over the overlap graph; None after 5 x tuple_size
        walks without tuple_size distinct views."""
        n_trials = 0
        result = []
        while len(result) < self.tuple_size and n_trials < 5 * self.tuple_size:
            key = start_key
            result = []
            for _ in range(self.tuple_size):
                next_key = int(self.rng.choice(candidates[key]))
                if next_key not in result:
                    result.append(next_key)
                key = next_key
            n_trials += 1
        if len(result) < self.tuple_size:
            return None
        if self.shuffle_tuple:
            self.rng.shuffle(result)
        return result

    def start_epoch(self, make_exclude_set=False, _first=False):
        """Resample all tuples (called before every epoch after the first)."""
        if not _first:
            self.epoch += 1
        tuples = []
        for scene in self.scenes:
            overlap_path = os.path.join(
                self.data_dir, "overlap",
                os.path.relpath(self.data_split_dir, self.data_dir),
                scene + ".json",
            )
            with open(overlap_path) as f:
                loaded = json.load(f)
            if len(loaded) < self.tuple_size:
                continue
            candidates = {int(k): v for k, v in loaded.items() if len(v) > 0}
            n_candidates = len(candidates)
            n_samples = (
                int(n_candidates / self.tuple_size)
                if self.n_samples is None
                else self.n_samples
            )
            n_samples = min(n_samples, n_candidates)
            keys = list(candidates.keys())
            start_images = self.rng.choice(keys, n_samples, replace=False)
            for start in start_images:
                t = self._make_tuple(int(start), candidates)
                n_trials = 0
                while t is None and (not make_exclude_set or n_trials < 3 * self.tuple_size):
                    alt = int(self.rng.choice(keys))
                    t = self._make_tuple(alt, candidates)
                    n_trials += 1
                if t is None:
                    if make_exclude_set:
                        self.exclude_set.add(scene)
                        break
                else:
                    tuples.append((scene, t))
        self.sampled_tuples = tuples
        return tuples

    def write_sampled_tuples(self, file_path, n=1500):
        """Write the first `n` tuples as the fixed-test-tuple CSV."""
        with open(file_path, "w") as f:
            f.write("scene,ids\n")
            for scene, ids in self.sampled_tuples[:n]:
                f.write(f'{scene},"{list(ids)}"\n')

    def read_sampled_tuples(self, file_path):
        """Replace the sampled tuples by those of a fixed-test-tuple CSV."""
        tuples = []
        with open(file_path) as f:
            for row in csv.DictReader(f):
                tuples.append((row["scene"], json.loads(row["ids"])))
        self.sampled_tuples = tuples

    # -- sample loading ----------------------------------------------------
    def __len__(self):
        return len(self.sampled_tuples)

    def _item_rng(self, index):
        """Per-item Generator, deterministic in (seed, epoch, index)."""
        return np.random.default_rng((self.seed, self.epoch, index))

    def _crop_square(self, rgb, depth, intr, center, rng):
        h, w = depth.shape
        if w > h:
            left = int((w - h) / 2) if center else int(rng.integers(0, w - h + 1))
            top, bottom, right = 0, h, left + h
        else:
            top = int((h - w) / 2) if center else int(rng.integers(0, h - w + 1))
            left, right, bottom = 0, w, top + w
        intr = crop_intrinsics(intr, left, top)
        return rgb[top:bottom, left:right], depth[top:bottom, left:right], intr

    def _getitem_native(self, index):
        """A sample decoded by the native runtime (scannet and matterport
        layouts): images and depths at the depth map's size."""
        scene, ids = self.sampled_tuples[index]
        per_image_intr = "matterport" in self.data_split_dir
        if not per_image_intr:
            scene_intr = read_intrinsics(self.data_split_dir, scene)
        sdir = os.path.join(self.data_split_dir, scene)
        rgb_paths = [os.path.join(sdir, "color", f"{id}.jpg") for id in ids]
        dep_paths = [os.path.join(sdir, "depth", f"{id}.png") for id in ids]
        dh, dw = native_loader.png_size(dep_paths[0])
        images, depths = native_loader.load_batch(rgb_paths, dep_paths, dh, dw)
        intrs, poses = [], []
        for i, id in enumerate(ids):
            intr = (
                read_intrinsics(self.data_split_dir, scene, id)
                if per_image_intr else scene_intr.copy()
            ).astype(np.float32)
            if intr.shape == (3, 3):
                intr4 = np.eye(4, dtype=np.float32)
                intr4[:3, :3] = intr
                intr = intr4
            rh, rw = native_loader.jpeg_size(rgb_paths[i])
            # 1296x968 color: the intrinsics of the 972-row padded frame, but
            # the decode resizes the unpadded 968 rows (see the module's doc)
            if rw == 1296 and rh == 968:
                rh += 4
                intr[1, 2] += 2
            if (rh, rw) != (dh, dw):
                intr = resize_intrinsics(intr, dw / rw, dh / rh)
            intrs.append(intr)
            poses.append(read_pose(self.data_split_dir, scene, id).astype(np.float32))
        return {
            "scene": scene,
            "ids": list(ids),
            "images": images[..., None],
            "intr": np.stack(intrs),
            "poses": np.stack(poses),
            "depths": depths,
        }

    def __getitem__(self, index):
        if self.use_native:
            return self._getitem_native(index)
        scene, ids = self.sampled_tuples[index]
        is_megadepth = "megadepth" in self.data_split_dir
        per_image_intr = is_megadepth or "matterport" in self.data_split_dir
        if not per_image_intr:
            scene_intr = read_intrinsics(self.data_split_dir, scene)
        item_rng = self._item_rng(index)
        jitter_p = (
            _color_jitter_params(item_rng, self.jitter) if self.jitter else None
        )
        images, intrs, poses, depths = [], [], [], []
        for id in ids:
            intr = (
                read_intrinsics(self.data_split_dir, scene, id)
                if per_image_intr
                else scene_intr.copy()
            ).astype(np.float32)
            if intr.shape == (3, 3):
                intr4 = np.eye(4, dtype=np.float32)
                intr4[:3, :3] = intr
                intr = intr4
            pose = read_pose(self.data_split_dir, scene, id).astype(np.float32)
            rgb = read_rgb(self.data_split_dir, scene, id).astype(np.float32) / 255.0
            if is_megadepth:
                import h5py

                with h5py.File(
                    os.path.join(self.data_split_dir, scene, "depth", f"{id}.h5"), "r"
                ) as hf:
                    depth = np.asarray(hf["depth"], np.float32)
                rgb, depth, intr = self._crop_square(
                    rgb, depth, intr, center=(self.split == "test"), rng=item_rng
                )
            else:
                depth = read_depth(self.data_split_dir, scene, id)
            # large-frame scannet color: pad 968 -> 972 rows
            if rgb.shape[1] == 1296 and rgb.shape[0] == 968:
                rgb = np.pad(rgb, ((2, 2), (0, 0), (0, 0)))
                intr[1, 2] += 2
            # resize rgb to the depth map's size, intrinsics rescaled
            if rgb.shape[:2] != depth.shape:
                fx = depth.shape[1] / rgb.shape[1]
                fy = depth.shape[0] / rgb.shape[0]
                intr = resize_intrinsics(intr, fx, fy)
                rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
            if jitter_p is not None:
                rgb = _apply_color_jitter(rgb, jitter_p)
            gray = _rgb_to_gray(rgb)
            images.append(gray[..., None])
            intrs.append(intr)
            poses.append(pose)
            depths.append(depth)
        return {
            "scene": scene,
            "ids": list(ids),
            "images": np.stack(images),
            "intr": np.stack(intrs),
            "poses": np.stack(poses),
            "depths": np.stack(depths),
        }


def _collate(samples):
    """Stack sample dicts into one numpy batch (scene names and ids as lists)."""
    return {
        "images": np.stack([s["images"] for s in samples]),
        "intr": np.stack([s["intr"] for s in samples]),
        "poses": np.stack([s["poses"] for s in samples]),
        "depths": np.stack([s["depths"] for s in samples]),
        "scene": [s["scene"] for s in samples],
        "ids": [s["ids"] for s in samples],
    }


def batch_iterator(dataset, batch_size, shuffle=True, drop_last=True, seed=0,
                   prefetch=2, indices=None, process_index=0, process_count=1):
    """Numpy batches of `dataset`, loaded `prefetch` ahead by one thread,
    the samples of a batch in parallel on up to one thread a core (OpenCV's
    decode and numpy's array work release the interpreter lock; a sample
    depends on its index alone, so the batches do not depend on the threads).

    The index order is `indices` (default: all), shuffled in place by
    `np.random.default_rng(seed)` when `shuffle`. Multi-process: `batch_size`
    is the global batch; every process derives the same order and loads only
    its `batch_size / process_count` slice of each batch. An exception raised
    while loading is raised here; a caller that stops early ends the thread.
    """
    if batch_size % process_count != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by {process_count} processes"
        )
    if process_count > 1 and not drop_last:
        # a short last global batch would give the processes unequal slices
        raise ValueError("drop_last=False unsupported with process_count > 1")
    if indices is None:
        indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    n = len(indices)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    per_proc = batch_size // process_count
    lo_proc = process_index * per_proc
    n_threads = max(1, min(per_proc, os.cpu_count() or 1))

    q = queue_mod.Queue(maxsize=prefetch)
    stop = object()
    closed = threading.Event()

    def put(item):
        """Queue `item` unless the consumer has gone; False once it has."""
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def producer():
        try:
            with ThreadPoolExecutor(n_threads) as pool:
                for b in range(n_batches):
                    chunk = indices[b * batch_size : (b + 1) * batch_size]
                    if process_count > 1:
                        chunk = chunk[lo_proc : lo_proc + per_proc]
                    samples = pool.map(lambda i: dataset[int(i)], chunk)
                    if not put(_collate(list(samples))):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            put(e)
            return
        put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        closed.set()
        t.join()
