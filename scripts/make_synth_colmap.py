"""Generate a synthetic COLMAP capture for the full-trainer artifact run.

Builds a structured ground-truth gaussian scene (floor sheet + colored
blob clusters + thin rods, ~150k gaussians), renders N ring views with the
production renderer, and writes a standard COLMAP capture layout:

    <out>/images/view_###.png
    <out>/sparse/0/{cameras.bin, images.bin, points3D.bin}
    <out>/gt.ply

The sparse model carries a subsampled "SfM" point cloud (GT means +
colors) and per-image 2D observations of those points, so
examples/train_colmap.py runs EXACTLY as on a real capture — COLMAP-seeded
init, ADC/MCMC density control, SH warmup, checkpointing, --depth-loss —
and examples/eval_colmap.py scores the result. (The reference has no
dataset tooling at all; its only scene source is a random cloud,
/root/reference/render_sample.py:86-109.)

Run on a GPU from the repository root:
  python -c "import runpy; runpy.run_path('scripts/make_synth_colmap.py', run_name='__main__')"
"""

from __future__ import annotations

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils import save_gaussian_ply, save_png

# Env-overridable so round-5's HD capture (960x540, richer content, more
# views — the trained-scene bench preset's source) reuses this generator
# without disturbing the original 512x512 capture's reproducibility.
OUT = os.environ.get("MS_OUT", "output/synth_scene")
H = int(os.environ.get("MS_H", 512))
W = int(os.environ.get("MS_W", 512))
N_VIEWS = int(os.environ.get("MS_NVIEWS", 28))
N_SFM = int(os.environ.get("MS_NSFM", 30_000))
N_OBS = int(os.environ.get("MS_NOBS", 1_500))  # 2D observations per view
DETAIL = float(os.environ.get("MS_DETAIL", 1.0))  # content richness scale
SH = 3


def build_scene(rng):
    """Structured GT: floor + 60 blob clusters + 40 rods (~150k total)."""
    parts = []

    def part(means, scales, colors, opac):
        n = means.shape[0]
        quats = rng.normal(size=(n, 4))
        parts.append((means, scales, quats, colors, np.full((n,), opac)))

    # Floor sheet at y = +1 (gsplat convention: +Y down), checkered color.
    n_f = round(40_000 * DETAIL)
    fx = rng.uniform(-2.2, 2.2, n_f)
    fz = rng.uniform(-2.2, 2.2, n_f)
    fy = np.full(n_f, 1.0) + rng.normal(0, 0.01, n_f)
    checker = ((np.floor(fx * 2) + np.floor(fz * 2)) % 2)[:, None]
    fcol = np.where(checker > 0, [0.75, 0.72, 0.65], [0.35, 0.38, 0.45])
    fcol = fcol + rng.normal(0, 0.03, (n_f, 3))
    part(np.stack([fx, fy, fz], -1),
         np.exp(rng.normal(-3.4, 0.25, (n_f, 3))) * [1, 0.25, 1],
         fcol, 0.92)

    # Blob clusters.
    for _ in range(round(60 * DETAIL)):
        n_c = rng.integers(1200, 2200)
        center = rng.uniform([-1.6, -0.4, -1.6], [1.6, 0.95, 1.6])
        radius = rng.uniform(0.08, 0.3)
        means = center + rng.normal(0, radius, (n_c, 3))
        base = rng.uniform(0.15, 0.95, 3)
        cols = np.clip(base + rng.normal(0, 0.08, (n_c, 3)), 0, 1)
        part(means, np.exp(rng.normal(-3.6, 0.3, (n_c, 3))), cols, 0.85)

    # Thin vertical rods (high-frequency structure for densification).
    for _ in range(round(40 * DETAIL)):
        n_r = 500
        x0, z0 = rng.uniform(-1.8, 1.8, 2)
        y = np.linspace(-0.3, 1.0, n_r) + rng.normal(0, 0.004, n_r)
        means = np.stack([np.full(n_r, x0) + rng.normal(0, 0.008, n_r),
                          y,
                          np.full(n_r, z0) + rng.normal(0, 0.008, n_r)], -1)
        base = rng.uniform(0.2, 1.0, 3)
        part(means, np.exp(rng.normal(-4.2, 0.2, (n_r, 3))),
             np.clip(base + rng.normal(0, 0.05, (n_r, 3)), 0, 1), 0.9)

    means = np.concatenate([p[0] for p in parts]).astype(np.float32)
    scales = np.log(np.concatenate([p[1] for p in parts])).astype(np.float32)
    quats = np.concatenate([p[2] for p in parts]).astype(np.float32)
    cols = np.concatenate([p[3] for p in parts]).astype(np.float32)
    opac = np.concatenate([p[4] for p in parts]).astype(np.float32)
    # SH degree-0 coefficients from RGB (C0 normalization).
    C0 = 0.28209479177387814
    feats = np.zeros((means.shape[0], 16, 3), np.float32)
    feats[:, 0, :] = (cols - 0.5) / C0
    return dict(means3d=jnp.asarray(means), scales=jnp.asarray(scales),
                quats=jnp.asarray(quats), opacities=jnp.asarray(opac),
                features=jnp.asarray(feats))


def ring_cameras():
    """Proper (det +1) world-to-camera look-at rotations.

    NOTE: library look_at mirrors the reference's construction
    (/root/reference/render_sample.py:12-30), whose [right; down; forward]
    stack has det -1 — fine for rendering, but a reflection cannot be
    written as a COLMAP quaternion, so this generator builds the proper
    right-handed basis (down = forward x right) itself.
    """
    cams = []
    up = np.array([0.0, 1.0, 0.0])
    for i in range(N_VIEWS):
        ang = 2.0 * np.pi * i / N_VIEWS
        r = 3.6 if i % 2 == 0 else 4.2
        eye = np.array([r * np.sin(ang),
                        -0.4 - 0.5 * (i % 3) * 0.4,
                        r * np.cos(ang)], np.float64)
        forward = np.array([0.0, 0.4, 0.0]) - eye
        forward /= np.linalg.norm(forward)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward]).astype(np.float32)
        T = (-R @ eye).astype(np.float32)
        cams.append((R, T))
    return cams


def rotmat_to_qvec(R):
    """(3,3) -> COLMAP wxyz quaternion."""
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


def write_sparse(sparse, cams, fx, obs_per_view, pts_xyz, pts_rgb):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<ii", 1, 1))  # camera_id 1, PINHOLE
        f.write(struct.pack("<QQ", W, H))
        f.write(struct.pack("<dddd", fx, fx, W / 2, H / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, (R, T) in enumerate(cams):
            q = rotmat_to_qvec(R)
            f.write(struct.pack("<i", i + 1))
            f.write(np.asarray(q, "<f8").tobytes())
            f.write(np.asarray(T, "<f8").tobytes())
            f.write(struct.pack("<i", 1))
            f.write(f"view_{i:03d}.png".encode() + b"\x00")
            xys, pids = obs_per_view[i]
            f.write(struct.pack("<Q", len(pids)))
            rec = np.zeros((len(pids), 3), "<f8")
            rec[:, :2] = xys
            rec[:, 2] = np.asarray(pids, "<i8").view("<f8")
            f.write(rec.tobytes())
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", pts_xyz.shape[0]))
        for pid in range(pts_xyz.shape[0]):
            f.write(struct.pack("<Q", pid))
            f.write(np.asarray(pts_xyz[pid], "<f8").tobytes())
            f.write(np.asarray(
                np.clip(pts_rgb[pid] * 255, 0, 255), np.uint8).tobytes())
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))  # empty track


def main():
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(OUT, "images"), exist_ok=True)
    gt = build_scene(rng)
    n = gt["means3d"].shape[0]
    print(f"GT scene: {n} gaussians", flush=True)
    op = np.clip(np.asarray(gt["opacities"]), 1e-4, 1 - 1e-4)
    save_gaussian_ply(os.path.join(OUT, "gt.ply"), {
        "means3d": np.asarray(gt["means3d"]),
        "scales": np.asarray(gt["scales"]),
        "quats": np.asarray(gt["quats"]),
        "opacities_raw": np.log(op / (1 - op)).astype(np.float32),
        "features": np.asarray(gt["features"]),
    })

    fx = 0.72 * W
    cams = ring_cameras()
    config = RenderConfig(tile_capacity=512, chunk_size=64, tile_batch=512,
                          max_tile_span=8, raster_impl="pallas")

    @jax.jit
    def render(p, cam):
        # Black background to match the trainer's zero-background renders.
        return render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=SH, config=config,
        )

    # "SfM" points: subsample the GT means.
    C0 = 0.28209479177387814
    sel = rng.choice(n, N_SFM, replace=False)
    pts_xyz = np.asarray(gt["means3d"])[sel].astype(np.float64)
    pts_rgb = np.clip(
        np.asarray(gt["features"])[sel, 0, :] * C0 + 0.5, 0, 1)

    obs_per_view = []
    for i, (R, T) in enumerate(cams):
        cam = Camera.create(R=R, T=T, H=H, W=W, fx=fx, fy=fx,
                            cx=W / 2, cy=H / 2)
        img = np.asarray(render(gt, cam))
        save_png(img, os.path.join(OUT, "images", f"view_{i:03d}.png"))
        # Project a subset of SfM points for this view's 2D observations.
        osel = rng.choice(N_SFM, N_OBS, replace=False)
        pc = pts_xyz[osel] @ np.asarray(R).T + np.asarray(T)
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + W / 2
        v = fx * pc[:, 1] / np.maximum(z, 1e-6) + H / 2
        ok = (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        obs_per_view.append(
            (np.stack([u[ok], v[ok]], -1), osel[ok].astype(np.int64))
        )
        print(f"  view {i:02d}: rendered, {int(ok.sum())} obs", flush=True)

    write_sparse(os.path.join(OUT, "sparse", "0"), cams, fx,
                 obs_per_view, pts_xyz, pts_rgb)

    # Round-trip sanity through the production loader.
    from mojosplat_jax.utils import colmap as cm

    scene = cm.load_scene(os.path.join(OUT, "sparse", "0"),
                          with_points2d=True)
    assert len(scene.images) == N_VIEWS
    assert scene.points_xyz.shape[0] == N_SFM
    r_err = 0.0
    for im in scene.images:
        idx = int(im.name[5:8])  # view_###.png
        cam_i = scene.camera_for(im, 1)
        r_err = max(r_err, float(
            np.abs(np.asarray(cam_i.R) - cams[idx][0]).max()
        ))
    print(f"load_scene round-trip OK; qvec->R max err {r_err:.2e}",
          flush=True)
    assert r_err < 1e-5


if __name__ == "__main__":
    main()
