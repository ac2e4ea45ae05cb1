"""Resample the synthetic capture's SfM model to a denser point cloud.

Rewrites ``output/synth_scene/sparse/0`` (points3D.bin + the per-image 2D
observations inside images.bin) from the capture's ground-truth PLY at a
higher point count, leaving the rendered images untouched. Used to seed
the round-4 training artifact with a >=100k-point COLMAP init (the
original capture wrote 30k). Pure numpy on the host: it never touches the
device.

  python -c "import runpy; runpy.run_path('scripts/resample_sfm.py', run_name='__main__')"
"""

import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

from mojosplat_jax.utils import load_gaussian_ply  # noqa: E402
from mojosplat_jax.utils import colmap as cm  # noqa: E402

# Env-overridable (round 5: reseed the HD capture at 1M points for the
# fixed-capacity trained-scene run).
ROOT = os.environ.get("MS_ROOT", "output/synth_scene")
SPARSE = os.path.join(ROOT, "sparse", "0")
N_SFM = int(os.environ.get("MS_NSFM", 110_000))
N_OBS = int(os.environ.get("MS_NOBS", 4_000))  # 2D observations per view
C0 = 0.28209479177387814


def rotmat_to_qvec(R):
    """(3,3) -> COLMAP wxyz quaternion (same construction as the maker)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w, x, y, z = 0.25 * s, (R[2, 1] - R[1, 2]) / s, \
            (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w, x, y, z = (R[2, 1] - R[1, 2]) / s, 0.25 * s, \
            (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w, x, y, z = (R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, \
            0.25 * s, (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w, x, y, z = (R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, \
            (R[1, 2] + R[2, 1]) / s, 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def main():
    rng = np.random.default_rng(11)
    scene = cm.load_scene(SPARSE)
    cam = scene.cameras[1]
    # Full intrinsics from the COLMAP record (fy/cx/cy may differ from the
    # fx / W/2 / H/2 assumptions on non-synthetic captures — round-4
    # advisor finding).
    fx, fy, cx, cy, W, H, _dist, _model = cm.camera_intrinsics(cam)

    ply = load_gaussian_ply(os.path.join(ROOT, "gt.ply"))
    means = np.asarray(ply["means3d"], np.float64)
    rgb = np.clip(
        np.asarray(ply["features"])[:, 0, :] * C0 + 0.5, 0.0, 1.0
    )
    # Sampling with replacement (plus a small positional jitter) covers
    # the N_SFM > n_gt case — the fixed-capacity trainer seed.
    replace = N_SFM > means.shape[0]
    sel = rng.choice(means.shape[0], N_SFM, replace=replace)
    pts_xyz, pts_rgb = means[sel].copy(), rgb[sel]
    if replace:
        pts_xyz += rng.normal(0, 0.01, pts_xyz.shape)

    # Per-view 2D observations of the resampled cloud.
    obs_per_view = []
    images = sorted(scene.images, key=lambda im: im.name)
    for im in images:
        R = cm.qvec_to_rotmat(im.qvec)
        T = np.asarray(im.tvec)
        osel = rng.choice(N_SFM, N_OBS, replace=False)
        pc = pts_xyz[osel] @ R.T + T
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        ok = (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        obs_per_view.append(
            (np.stack([u[ok], v[ok]], -1), osel[ok].astype(np.int64))
        )

    # Write to temp files and os.replace() only after the round-trip check
    # passes — an in-place overwrite that crashes mid-write would truncate
    # the only copy of the sparse model (round-4 advisor finding).
    with open(os.path.join(SPARSE, "images.bin.tmp"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im, (xys, pids) in zip(images, obs_per_view):
            R = cm.qvec_to_rotmat(im.qvec)
            f.write(struct.pack("<i", im.image_id))
            f.write(np.asarray(rotmat_to_qvec(R), "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(pids)))
            rec = np.zeros((len(pids), 3), "<f8")
            rec[:, :2] = xys
            rec[:, 2] = np.asarray(pids, "<i8").view("<f8")
            f.write(rec.tobytes())

    with open(os.path.join(SPARSE, "points3D.bin.tmp"), "wb") as f:
        f.write(struct.pack("<Q", pts_xyz.shape[0]))
        for pid in range(pts_xyz.shape[0]):
            f.write(struct.pack("<Q", pid))
            f.write(np.asarray(pts_xyz[pid], "<f8").tobytes())
            f.write(np.asarray(
                np.clip(pts_rgb[pid] * 255, 0, 255), np.uint8).tobytes())
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))

    # Validate the new model from a staging dir before touching the
    # originals, then atomically swap both files into place.
    stage = os.path.join(ROOT, "sparse", "_stage")
    os.makedirs(stage, exist_ok=True)
    try:
        import shutil

        shutil.copyfile(os.path.join(SPARSE, "cameras.bin"),
                        os.path.join(stage, "cameras.bin"))
        for name in ("images.bin", "points3D.bin"):
            os.replace(os.path.join(SPARSE, name + ".tmp"),
                       os.path.join(stage, name))
        check = cm.load_scene(stage, with_points2d=True)
        assert check.points_xyz.shape[0] == N_SFM
        assert len(check.images) == len(images)
        n_obs = sum(im.point3d_ids.shape[0] for im in check.images)
        for name in ("images.bin", "points3D.bin"):
            os.replace(os.path.join(stage, name), os.path.join(SPARSE, name))
    finally:
        import shutil

        shutil.rmtree(stage, ignore_errors=True)
    print(f"rewrote sparse model: {N_SFM} points, "
          f"{n_obs} observations over {len(images)} views", flush=True)


if __name__ == "__main__":
    main()
