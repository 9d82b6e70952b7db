"""Result browser of the port: serves an HTML gallery of the rendered
videos / images under logdir/ and database/, and a viewer of exported
per-frame meshes rendered on the server through the port's rasterizer
(utils/raster.py): the port of browser/app.py, on the standard library's
http.server.

  python -m lab4d_tpu_torch.browser.app [--port 8090] [--root .]
"""

from __future__ import annotations

import argparse
import glob
import html
import os
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

GALLERY_GLOBS = (
    "logdir/*/*.mp4",
    "logdir/*/*.gif",
    "logdir/*/renderings_*/*/*.mp4",
    "logdir/*/renderings_*/*/*.png",
    "database/processed/JPEGImages/Full-Resolution/*/00000.jpg",
)
PAGE_TMPL = """<!doctype html><html><head><title>lab4d-tpu results</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #eee; }}
 .grid {{ display: flex; flex-wrap: wrap; gap: 12px; }}
 .cell {{ width: 320px; }}
 .cell video, .cell img {{ width: 100%; border-radius: 6px; }}
 .cell .name {{ font-size: 12px; color: #9ad; word-break: break-all; }}
 h2 {{ color: #9ad; }}
</style></head><body>
<h2>lab4d-tpu result browser</h2>
<div class="grid">{cells}</div>
</body></html>"""


def build_index(root: str) -> str:
    cells = []
    for pattern in GALLERY_GLOBS:
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            rel = os.path.relpath(path, root)
            esc = html.escape(rel)
            if rel.endswith(".mp4"):
                media = f'<video src="/{esc}" controls loop muted></video>'
            else:
                media = f'<img src="/{esc}">'
            cells.append(
                f'<div class="cell">{media}<div class="name">{esc}</div></div>'
            )
    for exp_dir in sorted(glob.glob(os.path.join(root, "logdir/*/export_*"))):
        rel = os.path.relpath(exp_dir, root)
        esc = html.escape(rel)
        cells.append(
            f'<div class="cell"><a href="/viewer?dir={esc}" '
            f'style="color:#9ad">&#9654; 3D mesh viewer</a>'
            f'<div class="name">{esc}</div></div>'
        )
    if not cells:
        cells = ["<p>No results yet. Train something!</p>"]
    return PAGE_TMPL.format(cells="\n".join(cells))


VIEWER_TMPL = """<!doctype html><html><head><title>mesh viewer</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #eee; }}
 img {{ border-radius: 6px; max-width: 90vw; }}
 .bar {{ margin: 8px 0; }}
 input[type=range] {{ width: 420px; }}
</style></head><body>
<h2>{title}</h2>
<div class="bar">frame <input type="range" id="fr" min="0" max="{maxf}"
 value="0"> <span id="frv">0</span>
 &nbsp; azimuth <input type="range" id="az" min="0" max="350" step="10"
 value="30"> <span id="azv">30</span>&deg;</div>
<img id="view" src="/mesh.png?path={path0}&az=30">
<script>
 const objs = {objs};
 const img = document.getElementById('view');
 function upd() {{
   const f = document.getElementById('fr').value;
   const a = document.getElementById('az').value;
   document.getElementById('frv').textContent = f;
   document.getElementById('azv').textContent = a;
   img.src = '/mesh.png?path=' + objs[f] + '&az=' + a;
 }}
 document.getElementById('fr').oninput = upd;
 document.getElementById('az').oninput = upd;
</script></body></html>"""


def render_mesh_png(path: str, az_deg: float, res: int = 512) -> bytes:
    """One obj rendered from azimuth `az_deg` (15 deg up) as png bytes,
    through the numpy rasterizer: no GL, no three.js, the server renders."""
    import io as _io

    import numpy as np
    from PIL import Image

    from lab4d_tpu_torch.meshlib import load_obj
    from lab4d_tpu_torch.utils.raster import look_at, render_mesh

    mesh = load_obj(path)
    verts = np.asarray(mesh.vertices, np.float64)
    center = (verts.max(0) + verts.min(0)) / 2
    radius = float(np.linalg.norm(verts - center, axis=-1).max())
    ang = np.radians(az_deg)
    el = np.radians(15.0)
    eye = center + max(radius * 2.5, 1e-3) * np.array(
        [np.cos(el) * np.sin(ang), np.sin(el), -np.cos(el) * np.cos(ang)]
    )
    K = np.array([res, res, res / 2, res / 2], np.float64)
    img = render_mesh(
        verts, np.asarray(mesh.faces), look_at(eye, center), K, res
    )
    buf = _io.BytesIO()
    Image.fromarray((img * 255).astype("uint8")).save(buf, "PNG")
    return buf.getvalue()


def _safe_rel(root: str, rel: str):
    """Resolve rel under root, refusing path escapes."""
    full = os.path.realpath(os.path.join(root, rel))
    if not full.startswith(os.path.realpath(root) + os.sep):
        return None
    return full


class Handler(SimpleHTTPRequestHandler):
    def _send(self, body: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._send(build_index(os.getcwd()).encode(), "text/html")
        elif url.path == "/viewer":
            import json as _json
            import re as _re
            from urllib.parse import quote

            q = parse_qs(url.query)
            rel = q.get("dir", [""])[0]
            cate = q.get("cate", [""])[0]
            full = _safe_rel(os.getcwd(), rel)
            # per-FRAME meshes of one category: "<cate>-%05d.obj" only —
            # the pattern itself excludes "<cate>.obj" rest meshes and
            # "<cate>-%05d-bone.obj" bone meshes, matched on the
            # BASENAME so run/dir names may contain anything
            frame_re = _re.compile(r"^(.+)-(\d{5})\.obj$")
            by_cate = {}
            for p in sorted(glob.glob(os.path.join(full or "", "*.obj"))):
                m = frame_re.match(os.path.basename(p))
                if m:
                    by_cate.setdefault(m.group(1), []).append(p)
            if not by_cate:
                self._send(b"no per-frame .obj files found", "text/plain")
                return
            if cate not in by_cate:
                cate = sorted(by_cate)[0]
            objs = by_cate[cate]
            rels = [os.path.relpath(p, os.getcwd()) for p in objs]
            links = " | ".join(
                f'<a style="color:#9ad" href="/viewer?dir={quote(rel)}'
                f'&cate={quote(c)}">{html.escape(c)}</a>'
                for c in sorted(by_cate)
            )
            body = VIEWER_TMPL.format(
                title=html.escape(f"{rel} [{cate}]") + "<br>" + links,
                maxf=len(rels) - 1,
                path0=quote(rels[0]),
                objs=_json.dumps([quote(r) for r in rels]),
            ).encode()
            self._send(body, "text/html")
        elif url.path == "/mesh.png":
            q = parse_qs(url.query)
            full = _safe_rel(os.getcwd(), q.get("path", [""])[0])
            if (
                not full
                or not full.endswith(".obj")
                or not os.path.exists(full)
            ):
                self.send_error(404)
                return
            try:
                az = float(q.get("az", ["30"])[0])
            except ValueError:
                az = 30.0
            try:
                png = render_mesh_png(full, az)
            except Exception as exc:  # empty/corrupt mesh: report, not die
                self.send_error(500, f"render failed: {exc}")
                return
            self._send(png, "image/png")
        else:
            super().do_GET()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--root", default=".")
    args = ap.parse_args()
    os.chdir(args.root)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"browsing results at http://localhost:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
