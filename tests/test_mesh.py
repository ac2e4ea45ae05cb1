"""Mesh extraction tests: marching tetrahedra on analytic fields, TSDF
fusion, and end-to-end 2DGS surface reconstruction of a surfel sphere."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_jax import Camera, RenderConfig, look_at
from mojosplat_jax.surfel import render_surfels
from mojosplat_jax.utils.mesh import (
    marching_tetrahedra,
    save_mesh_obj,
    save_mesh_ply,
    tsdf_fuse,
)


def sphere_sdf(n=40, r=0.8, extent=1.2):
    ax = np.linspace(-extent, extent, n).astype(np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sp = ax[1] - ax[0]
    return (np.sqrt(X**2 + Y**2 + Z**2) - r, (-extent,) * 3, (sp,) * 3)


def test_marching_tets_sphere_geometry():
    sdf, origin, spacing = sphere_sdf()
    verts, faces = marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    assert len(verts) > 1000 and len(faces) > 2000
    rad = np.linalg.norm(verts, axis=-1)
    # Vertices on the analytic sphere within a fraction of a voxel.
    assert np.abs(rad - 0.8).max() < 0.1 * spacing[0]

    # Outward orientation everywhere (normal . position > 0 on a sphere).
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    cen = (a + b + c) / 3
    assert np.all(np.einsum("td,td->t", n, cen) > 0)

    # Area within 1% of 4 pi r^2; watertight topology (Euler = 2).
    area = 0.5 * np.linalg.norm(n, axis=-1).sum()
    assert abs(area - 4 * np.pi * 0.64) < 0.01 * 4 * np.pi * 0.64
    edges = np.unique(
        np.sort(np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]]
        ), axis=1), axis=0,
    )
    assert len(verts) - len(edges) + len(faces) == 2


def test_marching_tets_empty_and_mask():
    sdf, origin, spacing = sphere_sdf(n=16)
    verts, faces = marching_tetrahedra(sdf + 10.0)  # all outside
    assert len(verts) == 0 and len(faces) == 0
    # Full mask == no mask.
    v1, f1 = marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    v2, f2 = marching_tetrahedra(
        sdf, origin=origin, spacing=spacing, mask=np.ones(sdf.shape, bool)
    )
    assert len(v1) == len(v2) and len(f1) == len(f2)
    # All-false mask kills every cube.
    v3, f3 = marching_tetrahedra(
        sdf, mask=np.zeros(sdf.shape, bool)
    )
    assert len(v3) == 0


def test_mesh_writers(tmp_path):
    sdf, origin, spacing = sphere_sdf(n=12)
    verts, faces = marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    ply = tmp_path / "m.ply"
    obj = tmp_path / "m.obj"
    save_mesh_ply(str(ply), verts, faces)
    save_mesh_obj(str(obj), verts, faces)
    blob = ply.read_bytes()
    assert blob.startswith(b"ply") and f"element vertex {len(verts)}".encode() in blob
    lines = obj.read_text().splitlines()
    assert sum(1 for l in lines if l.startswith("v ")) == len(verts)
    assert sum(1 for l in lines if l.startswith("f ")) == len(faces)


def surfel_sphere(n_lat=24, n_lon=48, r=0.8):
    """Surfels tiling a sphere, tangent frames aligned to the surface."""
    thetas = np.linspace(0.15, np.pi - 0.15, n_lat)
    params = {"means3d": [], "quats": [], "scales": [], "opacities": [],
              "features": []}
    for th in thetas:
        for ph in np.linspace(0, 2 * np.pi, n_lon, endpoint=False):
            nrm = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                            np.sin(th) * np.sin(ph)])
            up = np.array([0.0, 1.0, 0.0])
            tu = np.cross(up, nrm)
            tu /= max(np.linalg.norm(tu), 1e-9)
            tv = np.cross(nrm, tu)
            # Rotation with columns [t_u, t_v, n] -> wxyz quaternion.
            M = np.stack([tu, tv, nrm], axis=1)
            w = np.sqrt(max(1.0 + M[0, 0] + M[1, 1] + M[2, 2], 1e-9)) / 2
            x = (M[2, 1] - M[1, 2]) / (4 * w)
            y = (M[0, 2] - M[2, 0]) / (4 * w)
            z = (M[1, 0] - M[0, 1]) / (4 * w)
            params["means3d"].append(r * nrm)
            params["quats"].append([w, x, y, z])
            params["scales"].append([np.log(0.09), np.log(0.09)])
            params["opacities"].append(0.98)
            params["features"].append([0.8, 0.6, 0.4])
    return {k: jnp.asarray(np.asarray(v, np.float32))
            for k, v in params.items()}


def test_end_to_end_sphere_reconstruction():
    p = surfel_sphere()
    cfg = RenderConfig(tile_capacity=256, chunk_size=64)
    H = W = 96
    focal = 70.0

    @jax.jit
    def depth_view(cam):
        img, depth, aux = render_surfels(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, config=cfg,
            return_depth=True, return_aux=True,
        )
        alpha = 1.0 - aux.raster.final_transmittance
        return (
            jnp.where(alpha > 1e-3, depth / jnp.maximum(alpha, 1e-3), 0.0),
            alpha,
        )

    cams, depths, alphas = [], [], []
    for el in (-0.35, 0.0, 0.35):
        for i in range(4):
            az = 2 * np.pi * i / 4 + el
            eye = 2.6 * np.array(
                [np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)]
            )
            R, T = look_at(eye=jnp.asarray(eye, jnp.float32),
                           target=jnp.zeros(3), up=jnp.array([0., 1., 0.]))
            cam = Camera.create(R=R, T=T, H=H, W=W, fx=focal, fy=focal,
                                cx=W / 2, cy=H / 2)
            ed, al = depth_view(cam)
            cams.append(cam)
            depths.append(np.asarray(ed))
            alphas.append(np.asarray(al))

    res = 64
    tsdf, w, origin, spacing = tsdf_fuse(
        depths, alphas, cams, ((-1.1,) * 3, (1.1,) * 3), resolution=res
    )
    assert (w > 0).mean() > 0.2  # most of the volume observed
    verts, faces = marching_tetrahedra(
        tsdf, origin=origin, spacing=spacing, mask=w > 0
    )
    assert len(verts) > 500 and len(faces) > 1000
    rad = np.linalg.norm(verts, axis=-1)
    # Reconstructed surface sits at the sphere radius within ~2 voxels.
    assert abs(float(np.median(rad)) - 0.8) < 2.1 * float(spacing[0])
    assert float(np.percentile(np.abs(rad - 0.8), 90)) < 3.0 * float(
        spacing[0]
    )
