"""Host-side OpenCV essential-matrix RANSAC (the upstream `estimate_pose`).

The port's copy of `e2e_multi_view_matching_tpu/geom/ransac.py`: numpy and
OpenCV on the host, the same arithmetic. cv2.findEssentialMat (RANSAC, prob
0.99999) on camera-normalized points, then cv2.recoverPose over every
candidate essential, keeping the solution with the most points in front.
`cli/eval_pairs.py` runs it per pair in its `ransac` and `ransac_ba` modes.
RANSAC's data-dependent control flow is host-shaped; the device's robust
alternative is the IRLS-gated w8pt of `mvba/pipeline.py::robust_relative_poses`.
"""

import numpy as np


def mean_focal(K0, K1):
    """Mean of all four focal lengths (fx0, fy0, fx1, fy1): the RANSAC
    threshold's normalization (the upstream expression double-counts fx0 and
    fy1, which differs where fx != fy or K0 != K1)."""
    return np.mean([K0[0, 0], K0[1, 1], K1[0, 0], K1[1, 1]])


def estimate_pose_ransac(mkpts0, mkpts1, K0, K1, thresh=1.0):
    """RANSAC relative pose from matched pixel keypoints.

    Args:
        mkpts0, mkpts1: (N, 2) matched pixel coordinates.
        K0, K1: (3, 3) intrinsics.
        thresh: inlier threshold in pixels (normalized by the mean focal length).
    Returns:
        (R (3, 3), t (3,), inlier_mask (N,) bool) or None on failure.
    """
    import cv2

    if len(mkpts0) < 5:
        return None
    norm_thresh = thresh / mean_focal(K0, K1)
    k0 = (mkpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    k1 = (mkpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    E, mask = cv2.findEssentialMat(
        k0, k1, np.eye(3), threshold=norm_thresh, prob=0.99999, method=cv2.RANSAC)
    if E is None:
        return None
    best = None
    for _E in np.split(E, len(E) // 3):
        n, R, t, _ = cv2.recoverPose(_E, k0, k1, np.eye(3), 1e9, mask=mask)
        if best is None or n > best[0]:
            best = (n, R, t[:, 0], mask.ravel() > 0)
    return best[1], best[2], best[3]
