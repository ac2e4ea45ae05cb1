"""NeRF-synthetic (Blender transforms.json) loader tests: the OpenGL
camera-to-world -> world-to-camera conversion round-trips against look_at
cameras, and RGBA frames composite onto the background."""

import json
import os

import jax.numpy as jnp
import numpy as np

from mojosplat_jax import Camera, look_at
from mojosplat_jax.utils.blender import load_blender_scene


def wc_to_c2w_gl(R, T):
    """Inverse of the loader's conversion: our world-to-camera (R, T) ->
    OpenGL camera-to-world 4x4."""
    flip = np.diag([1.0, -1.0, -1.0])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(R).T @ flip
    c2w[:3, 3] = -np.asarray(R).T @ np.asarray(T)
    return c2w


def write_scene(root, poses, H=32, W=32, angle_x=0.9):
    from PIL import Image

    frames = []
    rng = np.random.default_rng(0)
    for i, (R, T) in enumerate(poses):
        rgba = np.zeros((H, W, 4), np.uint8)
        rgba[..., 0] = 200  # red foreground
        rgba[..., 3] = 0
        rgba[: H // 2, :, 3] = 255  # top half opaque, bottom transparent
        name = f"r_{i}"
        Image.fromarray(rgba).save(os.path.join(root, name + ".png"))
        frames.append({
            "file_path": f"./{name}",
            "transform_matrix": wc_to_c2w_gl(R, T).tolist(),
        })
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": angle_x, "frames": frames}, f)


def test_pose_roundtrip_and_intrinsics(tmp_path):
    poses = []
    rng = np.random.default_rng(1)
    for i in range(3):
        eye = jnp.asarray(rng.normal(0, 2.0, 3).astype(np.float32))
        R, T = look_at(eye=eye, target=jnp.zeros(3),
                       up=jnp.array([0.0, 1.0, 0.0]))
        poses.append((np.asarray(R), np.asarray(T)))
    write_scene(str(tmp_path), poses)

    scene = load_blender_scene(str(tmp_path), split="train")
    assert len(scene.names) == 3 and scene.images.shape == (3, 32, 32, 3)
    for i, (R, T) in enumerate(poses):
        np.testing.assert_allclose(scene.R[i], R, atol=1e-5)
        np.testing.assert_allclose(scene.T[i], T, atol=1e-5)
    # fx from camera_angle_x: 0.5 * W / tan(angle/2).
    np.testing.assert_allclose(
        scene.fx, 0.5 * 32 / np.tan(0.45), rtol=1e-6
    )
    cam = scene.camera_for(0)
    assert isinstance(cam, Camera) and cam.H == 32
    np.testing.assert_allclose(np.asarray(cam.R), poses[0][0], atol=1e-5)


def test_alpha_composites_onto_background(tmp_path):
    R, T = look_at(eye=jnp.array([0.0, 0.0, -3.0]), target=jnp.zeros(3),
                   up=jnp.array([0.0, 1.0, 0.0]))
    write_scene(str(tmp_path), [(np.asarray(R), np.asarray(T))])
    white = load_blender_scene(str(tmp_path), background=(1.0, 1.0, 1.0))
    black = load_blender_scene(str(tmp_path), background=(0.0, 0.0, 0.0))
    # Opaque top half: red regardless of background.
    np.testing.assert_allclose(
        white.images[0][0, 0], [200 / 255, 0, 0], atol=1e-6
    )
    np.testing.assert_allclose(
        black.images[0][0, 0], [200 / 255, 0, 0], atol=1e-6
    )
    # Transparent bottom half: pure background.
    np.testing.assert_allclose(white.images[0][-1, -1], [1, 1, 1], atol=1e-6)
    np.testing.assert_allclose(black.images[0][-1, -1], [0, 0, 0], atol=1e-6)


def test_camera_points_at_scene_center(tmp_path):
    # A loaded camera must look AT the target: the target projects to the
    # principal point with positive depth (validates the +Z-forward flip).
    from mojosplat_jax.ops.projection import project_gaussians
    from mojosplat_jax import RenderConfig

    eye = jnp.array([1.5, -0.7, 2.2])
    R, T = look_at(eye=eye, target=jnp.zeros(3),
                   up=jnp.array([0.0, 1.0, 0.0]))
    write_scene(str(tmp_path), [(np.asarray(R), np.asarray(T))])
    scene = load_blender_scene(str(tmp_path))
    cam = scene.camera_for(0)
    res = project_gaussians(
        jnp.zeros((1, 3)), jnp.full((1, 3), -4.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]), jnp.array([0.9]), cam,
        RenderConfig(),
    )
    np.testing.assert_allclose(
        np.asarray(res.means2d[0]), [16.0, 16.0], atol=1e-3
    )
    assert float(res.depths[0]) > 0


def test_train_blender_cli_mcmc(tmp_path, capsys):
    """End-to-end training CLI on a synthetic Blender scene with MCMC
    density control: must run, relocate, and save the fitted PLY."""
    import sys

    poses = []
    for i in range(3):
        ang = 2.0 * np.pi * i / 3
        eye = jnp.asarray(
            [3.0 * np.sin(ang), 0.5, 3.0 * np.cos(ang)], jnp.float32
        )
        R, T = look_at(eye=eye, target=jnp.zeros(3),
                       up=jnp.array([0.0, 1.0, 0.0]))
        poses.append((np.asarray(R), np.asarray(T)))
    write_scene(str(tmp_path), poses, H=48, W=48)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = str(tmp_path / "out")
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(tmp_path), "--downscale", "1", "--steps", "10",
        "--impl", "xla", "--gaussians", "256", "--sh-degree", "0",
        "--strategy", "mcmc", "--densify-every", "5",
        "--out-dir", out_dir,
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "train_blender.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "[mcmc:" in out
    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
