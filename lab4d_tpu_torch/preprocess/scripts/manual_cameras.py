"""Manual key-frame camera annotation.

The reference ships a gradio+plotly GUI (reference:
preprocess/scripts/manual_cameras.py, 525 LoC) that writes
Cameras/<seq>/01-manual.json mapping frame index -> 4x4 canonical
object-to-camera transforms. Two workflows here:

  browser annotator (preferred, replaces the gradio tool):
    `python -m lab4d_tpu_torch.preprocess.scripts.manual_cameras serve <seq> [port]`
    serves a single-file HTML app (manual_cameras_app.html, no external
    deps): key-frame image on the left, a draggable shaded render of the
    template mesh on the right; Save writes 01-manual.json.

  file-based fallback:
    1. `python -m lab4d_tpu_torch.preprocess.scripts.manual_cameras template <seq> [n_key]`
       writes a template json with turntable guesses at key frames.
    2. Edit the rotations (any external tool / known rig).

  run_preprocess picks the json up automatically for obj_class=other.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np



def turntable_guess(num_frames: int, num_key: int = 8):
    """Evenly-spaced azimuth guesses: a sane starting template."""
    out = {}
    for i in range(num_key):
        t = i / num_key
        ang = 2 * np.pi * t
        rt = np.eye(4)
        rt[:3, :3] = np.array(
            [
                [np.cos(ang), 0, -np.sin(ang)],
                [0, 1, 0],
                [np.sin(ang), 0, np.cos(ang)],
            ]
        )
        rt[2, 3] = 3.0
        frame = int(round(t * (num_frames - 1)))
        out[frame] = rt.tolist()
    return out


def write_template(seqname: str, outdir: str = "database/processed", num_key: int = 8):
    from lab4d_tpu_torch.preprocess.libs.io import frame_list

    n = len(frame_list(outdir, seqname))
    cam_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    os.makedirs(cam_dir, exist_ok=True)
    path = f"{cam_dir}/01-manual.json"
    with open(path, "w") as f:
        json.dump(turntable_guess(n, num_key), f, indent=1)
    print(f"wrote manual-camera template: {path} — edit before training")
    return path


def ensure_manual_cameras(seqnames, outdir: str = "database/processed"):
    """Write templates for any sequence missing its manual json."""
    missing = []
    for s in seqnames:
        path = f"{outdir}/Cameras/Full-Resolution/{s}/01-manual.json"
        if not os.path.exists(path):
            write_template(s, outdir)
            missing.append(s)
    if missing:
        print(
            "manual cameras: template jsons were generated for "
            f"{missing}; edit them for best results (turntable guess used)."
        )


# ----------------------------------------------------------- browser tool


def _load_template_mesh(template_path=None, max_faces: int = 6000):
    """Template mesh as JSON-able dict, centered and unit-scaled."""
    if template_path is None:
        template_path = "database/mesh-templates/cat-pikachu-remeshed.obj"
        if not os.path.exists(template_path):
            repo_root = os.path.abspath(
                os.path.join(os.path.dirname(__file__), "../../..")
            )
            template_path = os.path.join(repo_root, template_path)
    verts, faces = [], []
    if os.path.exists(template_path):
        with open(template_path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
                elif line.startswith("f "):
                    idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:4]]
                    faces.append(idx)
    if not verts:  # fallback: icosphere-ish box so the tool still works
        verts = [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
        faces = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                 [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                 [1, 5, 7], [1, 7, 3]]
    v = np.asarray(verts, np.float32)
    v = v - v.mean(0)
    v = v / (np.abs(v).max() + 1e-8)
    if len(faces) > max_faces:
        faces = faces[:: len(faces) // max_faces + 1]
    return {"verts": np.round(v, 4).tolist(), "faces": faces}


def make_server(seqname: str, outdir: str = "database/processed",
                port: int = 8494, template_path=None):
    """Build the annotator TCPServer (tests run it on a thread; `serve`
    blocks on it)."""
    import http.server
    import socketserver

    from lab4d_tpu_torch.preprocess.libs.io import frame_list

    frames = frame_list(outdir, seqname)
    if not frames:
        raise FileNotFoundError(
            f"no frames under {outdir}/JPEGImages/Full-Resolution/{seqname}"
        )
    num_key = min(8, len(frames))
    key_frames = [
        int(round(i * (len(frames) - 1) / max(num_key - 1, 1)))
        for i in range(num_key)
    ]
    cam_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    os.makedirs(cam_dir, exist_ok=True)
    save_path = f"{cam_dir}/01-manual.json"
    existing = {}
    if os.path.exists(save_path):
        with open(save_path) as f:
            existing = json.load(f)
        key_frames = sorted(set(key_frames) | {int(k) for k in existing})
    img_dir = f"{outdir}/JPEGImages/Full-Resolution/{seqname}"
    mesh = _load_template_mesh(template_path)
    app_html = open(
        os.path.join(os.path.dirname(__file__), "manual_cameras_app.html"),
        "rb",
    ).read()

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, body, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body if isinstance(body, bytes)
                             else json.dumps(body).encode())

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(app_html, "text/html")
            elif self.path == "/meta":
                self._send({"seqname": seqname, "frames": key_frames,
                            "existing": existing})
            elif self.path == "/mesh":
                self._send(mesh)
            elif self.path.startswith("/frame/"):
                fid = int(self.path.split("/")[-1])
                for ext in ("jpg", "png"):
                    p = f"{img_dir}/{fid:05d}.{ext}"
                    if os.path.exists(p):
                        self._send(open(p, "rb").read(), "image/" + ext)
                        return
                self.send_error(404)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/save":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n))
            with open(save_path, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"wrote {save_path} ({len(payload)} key frames)")
            self._send({"ok": True})

        def log_message(self, *a):  # quiet
            pass

    socketserver.TCPServer.allow_reuse_address = True
    srv = socketserver.TCPServer(("", port), Handler)
    print(f"manual-camera annotator: http://localhost:{srv.server_address[1]}"
          f"  (seq={seqname}, {len(key_frames)} key frames)")
    return srv


def serve(seqname: str, outdir: str = "database/processed", port: int = 8494,
          template_path=None):
    """Serve the browser annotator for one sequence (blocks)."""
    with make_server(seqname, outdir, port, template_path) as srv:
        srv.serve_forever()


if __name__ == "__main__":
    if sys.argv[1] == "template":
        write_template(sys.argv[2], num_key=int(sys.argv[3]) if len(sys.argv) > 3 else 8)
    elif sys.argv[1] == "serve":
        serve(
            sys.argv[2],
            port=int(sys.argv[3]) if len(sys.argv) > 3 else 8494,
            outdir=sys.argv[4] if len(sys.argv) > 4 else "database/processed",
        )
    else:
        print(__doc__)
