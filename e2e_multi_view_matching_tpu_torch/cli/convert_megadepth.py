"""MegaDepth -> ScanNet-format converter.

Counterpart of `e2e_multi_view_matching_tpu/cli/convert_megadepth.py`:

    python -m e2e_multi_view_matching_tpu_torch.cli.convert_megadepth \
        --dataset_dir <megadepth> [--image_size 640] [--n_workers 12]

reads the D2-Net-undistorted MegaDepth images + LoFTR-style `scene_info` npz
per scene, writes the ScanNet directory layout (color jpg / depth h5 /
per-image intrinsic + pose txt) resized so the smaller image dimension equals
`--image_size`, and builds the per-scene overlap JSON (mean of the asymmetric
overlap matrix entries within [0.1, 0.7] for train/val and [0.1, 0.4] for test
-- the SuperGlue ranges). Output ids are renumbered densely over valid images.

Scenes run in a pool of `--n_workers` spawned processes, and a second run
skips every scene whose overlap JSON exists. The depth h5 files are what
`data/tuples.py` reads for MegaDepth; `h5py` is imported where it is used.
"""

import argparse
import json
import logging
import os
import shutil
import multiprocessing

import cv2
import numpy as np

from e2e_multi_view_matching_tpu_torch.data.scannet import get_scenes, resize_intrinsics

log = logging.getLogger("convert_megadepth")


class ConvertMegadepthScene:
    def __init__(self, scene_info_dir, dataset_dir, out_dataset_dir, image_size,
                 valid_list, train_scenes, val_scenes, test_scenes):
        self.scene_info_dir = scene_info_dir
        self.dataset_dir = dataset_dir
        self.out_dataset_dir = out_dataset_dir
        self.image_size = image_size
        self.valid_list = set(valid_list)
        self.train_scenes = set(train_scenes)
        self.val_scenes = set(val_scenes)
        self.test_scenes = set(test_scenes)

    def __call__(self, scene_info_file):
        import h5py

        scene = scene_info_file.split(".")[0]
        split_dir = "scans"
        if scene in self.train_scenes or scene in self.val_scenes:
            upper_overlap_limit = 0.7  # from SuperGlue
        elif scene in self.test_scenes:
            split_dir += "_test"
            upper_overlap_limit = 0.4
        else:
            return
        log.info("processing scene %s", scene)
        info = np.load(os.path.join(self.scene_info_dir, scene_info_file),
                       allow_pickle=True)
        img_paths = info["image_paths"]
        depth_paths = info["depth_paths"]
        intrinsics = info["intrinsics"]
        poses = info["poses"]
        overlap_matrix = info["overlap_matrix"]
        n = len(img_paths)

        count = 0
        matches = {}
        valid_path_mask = np.array([p is not None for p in img_paths], bool)
        img_ids = np.zeros(n, int)
        img_ids[valid_path_mask] = np.arange(valid_path_mask.sum())
        for i in range(n):
            rgb_path, depth_path = img_paths[i], depth_paths[i]
            if rgb_path is None or depth_path is None:
                continue
            file_id = f"{scene}/{rgb_path.split('/')[-1]}"
            if file_id not in self.valid_list:
                log.warning("%s not in valid list", file_id)
                continue
            bgr = cv2.imread(os.path.join(self.dataset_dir, rgb_path), cv2.IMREAD_COLOR)
            dp = os.path.join(self.dataset_dir, "/".join(depth_path.split("/")[-5:]))
            with h5py.File(dp, "r") as hf:
                depth = np.asarray(hf["depth"])
            if bgr.shape[:2] != depth.shape:
                raise RuntimeError(f"RGB/depth dimension mismatch for {file_id}")
            # symmetric mean overlap, both directions nonzero, in range
            row = overlap_matrix[i, :]
            col = overlap_matrix[:, i]
            overlap = 0.5 * (row + col)
            mask = ((overlap >= 0.1) & (overlap <= upper_overlap_limit)
                    & (row > 0) & (col > 0) & valid_path_mask)
            matches[str(count)] = img_ids[mask].tolist()
            # resize: smaller dimension to image_size, keep aspect
            h, w = bgr.shape[:2]
            if w > h:
                new_h, new_w = self.image_size, int(self.image_size * w / h)
            else:
                new_h, new_w = int(self.image_size * h / w), self.image_size
            bgr = cv2.resize(bgr, (new_w, new_h), interpolation=cv2.INTER_AREA)
            depth = cv2.resize(depth, (new_w, new_h), interpolation=cv2.INTER_NEAREST)
            intr = np.eye(4)
            intr[:3, :3] = intrinsics[i]
            intr = resize_intrinsics(intr, new_w / w, new_h / h)

            scene_dir = os.path.join(self.out_dataset_dir, split_dir, scene)
            for sub in ("color", "depth", "intrinsic", "pose"):
                os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
            cv2.imwrite(os.path.join(scene_dir, "color", f"{count}.jpg"), bgr)
            with h5py.File(os.path.join(scene_dir, "depth", f"{count}.h5"), "w") as hf:
                hf.create_dataset("depth", data=depth)
            np.savetxt(os.path.join(scene_dir, "intrinsic", f"{count}.txt"), intr)
            # scene_info poses are world->cam; ScanNet layout stores cam->world
            np.savetxt(os.path.join(scene_dir, "pose", f"{count}.txt"),
                       np.linalg.inv(poses[i]))
            count += 1

        overlap_dir = os.path.join(self.out_dataset_dir, "overlap", split_dir)
        os.makedirs(overlap_dir, exist_ok=True)
        with open(os.path.join(overlap_dir, scene + ".json"), "w") as f:
            json.dump(matches, f, indent=4)
        log.info("scene %s: %d valid files", scene, count)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(
        description="Convert MegaDepth into ScanNet format",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--image_size", type=int, default=640,
                        help="length of smaller image dimension")
    parser.add_argument("--n_workers", type=int, default=12)
    opt = parser.parse_args(argv)

    out_dir = f"{opt.dataset_dir}_{opt.image_size}"
    train_scenes = [str(s).zfill(4) for s in get_scenes(opt.dataset_dir, "train")]
    val_scenes = [str(s).zfill(4) for s in get_scenes(opt.dataset_dir, "val")]
    test_scenes = [str(s).zfill(4) for s in get_scenes(opt.dataset_dir, "test")]
    for sub in ("scans", "scans_test", "overlap/scans", "overlap/scans_test"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for split in ("train", "val", "test"):
        shutil.copyfile(os.path.join(opt.dataset_dir, f"megadepth_{split}.txt"),
                        os.path.join(out_dir, f"megadepth_{split}.txt"))
    with open(os.path.join(opt.dataset_dir, "megadepth_valid_list.json")) as f:
        valid_list = list(json.load(f))

    scene_info_dir = os.path.join(opt.dataset_dir, "scene_info")
    done = set(os.listdir(os.path.join(out_dir, "overlap", "scans"))) | set(
        os.listdir(os.path.join(out_dir, "overlap", "scans_test"))
    )
    files = [s for s in sorted(os.listdir(scene_info_dir))
             if s.split(".")[0] + ".json" not in done]
    log.info("scenes to extract: %d", len(files))
    converter = ConvertMegadepthScene(
        scene_info_dir, opt.dataset_dir, out_dir, opt.image_size, valid_list,
        train_scenes, val_scenes, test_scenes,
    )
    if opt.n_workers > 1:
        with multiprocessing.get_context("spawn").Pool(opt.n_workers) as pool:
            pool.map(converter, files)
    else:
        for f in files:
            converter(f)


if __name__ == "__main__":
    main()
