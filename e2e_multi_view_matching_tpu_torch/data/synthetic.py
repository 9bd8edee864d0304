"""Synthetic multi-view scenes with exact analytic depth (host-side numpy).

The port's own copy of what a seeded training batch needs from
`e2e_multi_view_matching_tpu/data/synthetic.py`: a textured tilted plane seen
by V perturbed cameras gives exact depth maps (closed-form ray-plane
intersection), exact poses and therefore exact correspondences, the oracle
for GT matches and for training on data made from a seed. Writing a
ScanNet-format tree comes with the dataset readers.
"""

import numpy as np


def _rotation_from_axis_angle(w):
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class PlaneScene:
    """A tilted plane in world space, viewed by V cameras near the origin.

    Attributes:
        poses: (V, 4, 4) cam->world transforms.
        intr: (V, 3, 3) shared pinhole intrinsics.
        H, W: image size.
    """

    def __init__(self, rng, n_views=2, H=120, W=160, f=140.0, plane_z=5.0,
                 tilt=0.15, baseline=0.5, rot_jitter=0.08):
        self.H, self.W = H, W
        self.intr = np.tile(
            np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64), (n_views, 1, 1)
        )
        # plane: n . X = c in world coords, mostly fronto-parallel
        n = np.array([tilt * rng.normal(), tilt * rng.normal(), 1.0])
        self.plane_n = n / np.linalg.norm(n)
        self.plane_c = self.plane_n @ np.array([0.0, 0.0, plane_z])
        poses = []
        for v in range(n_views):
            R = _rotation_from_axis_angle(rng.normal(size=3) * rot_jitter)
            t = rng.normal(size=3) * baseline * np.array([1.0, 1.0, 0.3])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            poses.append(T)
        self.poses = np.stack(poses)  # cam -> world

    def _pixel_grid(self):
        xs, ys = np.meshgrid(np.arange(self.W, dtype=np.float64),
                             np.arange(self.H, dtype=np.float64))
        return np.stack([xs.ravel(), ys.ravel()], -1)

    def depth_at(self, v, pix):
        """Exact depth at (N, 2) float pixel coords in view v (0 where the ray
        runs parallel to the plane)."""
        Kinv = np.linalg.inv(self.intr[v])
        rays_cam = np.concatenate([pix, np.ones((len(pix), 1))], -1) @ Kinv.T
        R = self.poses[v][:3, :3]
        c = self.poses[v][:3, 3]
        denom = (rays_cam @ R.T) @ self.plane_n
        num = self.plane_c - c @ self.plane_n
        hit = np.abs(denom) > 1e-9
        return np.where(hit, num / np.where(hit, denom, 1.0), 0.0)

    def depth_map(self, v):
        """Exact (H, W) depth of the plane in view v (0 where the ray misses)."""
        depth = self.depth_at(v, self._pixel_grid()).reshape(self.H, self.W)
        return np.clip(depth, 0.0, None).astype(np.float32)


def fourier_texture_image(scene, v, rng=None, n_waves=24, seed=0):
    """Random-Fourier-feature texture on the scene geometry, (H, W) in [0.1, 0.9].

    Every world point gets a distinctive local appearance, img(X) =
    sum_i a_i sin(k_i . X + phi_i) with random frequencies, so that keypoint
    descriptors carry geometric identity. The waves are drawn once per scene.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    if not hasattr(scene, "_texture"):
        ks = rng.normal(size=(n_waves, 3)) * rng.uniform(2.0, 9.0, size=(n_waves, 1))
        phis = rng.uniform(0, 2 * np.pi, size=n_waves)
        amps = rng.uniform(0.3, 1.0, size=n_waves)
        scene._texture = (ks, phis, amps)
    ks, phis, amps = scene._texture
    pix = scene._pixel_grid()
    d = scene.depth_at(v, pix)
    rays_cam = np.concatenate([pix, np.ones((len(pix), 1))], -1) @ np.linalg.inv(scene.intr[v]).T
    Xw = (rays_cam * d[:, None]) @ scene.poses[v][:3, :3].T + scene.poses[v][:3, 3]
    val = (np.sin(Xw @ ks.T + phis[None]) * amps[None]).sum(-1)
    val = (val - val.min()) / max(val.max() - val.min(), 1e-6)
    return (0.1 + 0.8 * val).reshape(scene.H, scene.W).astype(np.float32)


def training_batch(rng, batch_size, n_views, H, W, f):
    """One seeded training batch of `batch_size` plane scenes, in the layout
    the train step takes: images (B, V, H, W, 1), intr (B, V, 3, 3), poses
    (B, V, 4, 4) cam->world, depths (B, V, H, W), all float32."""
    images, intr, poses, depths = [], [], [], []
    for _ in range(batch_size):
        scene = PlaneScene(rng, n_views=n_views, H=H, W=W, f=f)
        images.append(np.stack([fourier_texture_image(scene, v, rng=rng)
                                for v in range(n_views)])[..., None])
        depths.append(np.stack([scene.depth_map(v) for v in range(n_views)]))
        intr.append(scene.intr)
        poses.append(scene.poses)
    return {"images": np.stack(images).astype(np.float32),
            "intr": np.stack(intr).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "depths": np.stack(depths).astype(np.float32)}
