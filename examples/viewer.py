"""Interactive web viewer: drag-to-orbit a 3DGS scene rendered live on a GPU.

The ecosystem component every contemporary splatting framework ships (the
reference stops at a single demo PNG, render_sample.py:129-136). Zero
dependencies beyond the framework: a stdlib http.server serves one HTML
canvas page; every mouse drag requests /render?az=..&el=..&r=.., which
renders through the jitted pipeline (camera is a jit ARGUMENT — moving the
view never recompiles; one compile total at startup) and streams a PNG
encoded by the native C encoder.

Usage:
  python examples/viewer.py                      # random demo scene
  python examples/viewer.py --ply scene.ply      # a trained scene
  python examples/viewer.py --npz scene.npz      # a compressed scene
then open http://localhost:8090/.

The server is single-threaded by design: render requests serialize, so only
one render is ever in flight on the device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mojosplat_jax import (
    Camera,
    RenderConfig,
    look_at,
    render_gaussians,
    render_surfels,
)
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils.image import encode_png
from mojosplat_jax.utils.runtime import enable_compile_cache

PAGE = """<!doctype html>
<html><head><title>mojosplat-jax viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
#hud { position:fixed; top:8px; left:10px; pointer-events:none; }
canvas { display:block; margin:0 auto; cursor:grab; }
</style></head><body>
<div id="hud">drag = orbit &nbsp; wheel = zoom &nbsp; <span id="ms"></span></div>
<canvas id="c" width="__W__" height="__H__"></canvas>
<script>
const c = document.getElementById('c'), hud = document.getElementById('ms');
let az = 0.0, el = 0.25, r = __R__, busy = false, dirty = true;
function fetchFrame() {
  if (busy) { return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  const img = new Image();
  img.onload = () => {
    c.getContext('2d').drawImage(img, 0, 0);
    hud.textContent = Math.round(performance.now() - t0) + ' ms';
    busy = false;
    if (dirty) fetchFrame();
  };
  img.onerror = () => { busy = false; };
  img.src = `/render?az=${az.toFixed(4)}&el=${el.toFixed(4)}&r=${r.toFixed(4)}&t=${Date.now()}`;
}
let drag = null;
c.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  az += (e.clientX - drag[0]) * 0.01;
  el = Math.max(-1.5, Math.min(1.5, el + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  dirty = true; fetchFrame();
});
c.addEventListener('wheel', e => {
  e.preventDefault();
  r *= Math.exp(e.deltaY * 0.001);
  dirty = true; fetchFrame();
});
fetchFrame();
</script></body></html>
"""


def load_params(args):
    if args.ply:
        from mojosplat_jax.utils.ply import load_gaussian_ply

        raw = load_gaussian_ply(args.ply)
    elif args.npz:
        from mojosplat_jax.utils.compress import load_compressed_scene

        raw = load_compressed_scene(args.npz)
    else:
        raw = mtrain.init_gaussians(
            jax.random.PRNGKey(42), args.gaussians, sh_degree=None,
            position_scale=1.0,
        )
        raw = {k: np.asarray(v) for k, v in raw.items()}
    feats = np.asarray(raw["features"])
    sh_degree = None
    if feats.ndim == 3:
        sh_degree = int(round(feats.shape[1] ** 0.5)) - 1
    # Two scale columns = a 2DGS surfel scene (utils/ply.py layout note).
    surfels = np.asarray(raw["scales"]).shape[-1] == 2
    return {k: jnp.asarray(v) for k, v in raw.items()}, sh_degree, surfels


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--npz", default=None, help="compressed scene")
    ap.add_argument("--gaussians", type=int, default=20000)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--focal", type=float, default=600.0)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--tile-capacity", type=int, default=512)
    args = ap.parse_args()
    enable_compile_cache()

    raw, sh_degree, surfels = load_params(args)
    p = mtrain.activate(dict(raw))
    n = p["means3d"].shape[0]
    center = np.asarray(jnp.mean(p["means3d"], axis=0))
    extent = float(np.percentile(np.linalg.norm(
        np.asarray(p["means3d"]) - center, axis=-1), 90))
    radius0 = max(2.5 * extent, 1e-2)
    H, W = args.height, args.width

    config = RenderConfig(
        raster_impl=args.impl, tile_capacity=args.tile_capacity,
        chunk_size=64,
    )

    render_prim = render_surfels if surfels else render_gaussians

    @jax.jit
    def render(params, cam):
        return render_prim(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], params["features"], cam,
            sh_degree=sh_degree,
            background_color=jnp.array([0.08, 0.08, 0.10]), config=config,
        )

    def camera_for(az, el, r):
        eye = center + r * np.array(
            [np.sin(az) * np.cos(el), np.sin(el), np.cos(az) * np.cos(el)]
        )
        R, T = look_at(
            eye=jnp.asarray(eye, jnp.float32),
            target=jnp.asarray(center, jnp.float32),
            up=jnp.array([0.0, 1.0, 0.0]),
        )
        return Camera.create(R=R, T=T, H=H, W=W, fx=args.focal,
                             fy=args.focal, cx=W / 2, cy=H / 2)

    print(f"{n} {'surfels' if surfels else 'gaussians'} "
          f"(SH degree {sh_degree}); compiling at "
          f"{W}x{H} on {jax.default_backend()} ...")
    t0 = time.perf_counter()
    frame = render(p, camera_for(0.0, 0.25, radius0))
    jax.block_until_ready(frame)
    print(f"compiled + first frame in {time.perf_counter() - t0:.1f} s "
          f"(later frames reuse the compile; camera is a jit argument)")

    page = (PAGE.replace("__W__", str(W)).replace("__H__", str(H))
            .replace("__R__", f"{radius0:.4f}"))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/render":
                q = urllib.parse.parse_qs(url.query)
                az = float(q.get("az", [0.0])[0])
                el = float(q.get("el", [0.25])[0])
                r = float(q.get("r", [radius0])[0])
                img = np.asarray(render(p, camera_for(az, el, r)))
                body = encode_png(
                    (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
                )
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(404)
            self.end_headers()

    srv = HTTPServer(("127.0.0.1", args.port), Handler)
    print(f"viewer at http://localhost:{args.port}/  (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
