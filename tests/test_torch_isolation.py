"""The port stands alone: nothing under lab4d_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax, absl, imageio, matplotlib, the
JAX package (lab4d_tpu) or the repo's other root packages (scripts,
tests, preprocess, browser), not even a module of them that has no JAX
in it; the card that runs the port has none of them.

- an AST scan of every import statement, and of every string literal
  for import statements and dotted lab4d_tpu module names (a program
  kept in a string and run in a child interpreter imports too);
- the preprocessing port (lab4d_tpu_torch/preprocess/) also imports no
  sklearn;
- a fresh interpreter in which those modules cannot be imported trains
  the bg field for two steps on the CPU (synthetic scene, prior fits,
  batches through the native sampler, the round's eval render, checkpoint)
  and renders it, imports the flag schema, the profiling, raster,
  metrics and PSNR-comparison modules, the process-group helpers
  (parallel/dist.py), the device map and the sharded-step tool, the five
  net trainers (the depth net's trains two steps and its file loads), the
  adversarial scene, the tools of lab4d_tpu_torch/scripts/ and the
  browser, and then holds none of them in sys.modules.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lab4d_tpu")
# the card has none of these either, and the repo's root packages are the
# JAX package's tools
OUTSIDE = ("optax", "absl", "imageio", "matplotlib", "scripts", "tests", "preprocess",
           "browser")
PORT_FORBIDDEN = FORBIDDEN + OUTSIDE
# the preprocessing port imports no sklearn either
PREPROCESS_FORBIDDEN = PORT_FORBIDDEN + ("sklearn",)
SOURCES = sorted((REPO / "lab4d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    rel = path.relative_to(REPO).as_posix()
    forbidden = (PREPROCESS_FORBIDDEN if rel.startswith("lab4d_tpu_torch/preprocess/")
                 else PORT_FORBIDDEN)
    bad = [(line, name) for line, name in _imported_roots(path)
           if name.split(".")[0] in forbidden]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# a program kept in a string (run with `python -c` or exec) imports too
_ROOTS = ("jax|jaxlib|flax|lab4d_tpu|optax|absl|imageio|matplotlib|scripts|tests|preprocess"
          "|browser")
_IMPORT_IN_TEXT = re.compile(
    rf"\bimport\s+({_ROOTS})\b(?![/_])"
    rf"|\bfrom\s+({_ROOTS})(\.\w+)*\s+import\b"
    r"|\blab4d_tpu\.\w")


def _imports_in_strings(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in _IMPORT_IN_TEXT.finditer(node.value):
                yield node.lineno, m.group(0)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_strings(path):
    bad = list(_imports_in_strings(path))
    assert not bad, f"{path.relative_to(REPO)} holds imports in string literals: {bad}"


def test_string_scan_sees_a_program_in_a_string(tmp_path):
    src = tmp_path / "m.py"
    src.write_text('CODE = r"""\nimport jax\nfrom lab4d_tpu.config import get_config\n'
                   'from lab4d_tpu_torch.tools import compare_psnr\n"""\n'
                   'DOC = "a copy of lab4d_tpu/config.py, as from lab4d_tpu/render.py"\n'
                   'MOD = "lab4d_tpu.engine.trainer"\n'
                   'MORE = "from tests.synthetic_raw import render_frame; import imageio"\n'
                   'PATHS = "scripts/train_seg_unet.py, from lab4d_tpu_torch.scripts import x"\n')
    found = [text for _, text in _imports_in_strings(src)]
    assert found == ["import jax", "from lab4d_tpu.config import", "lab4d_tpu.e",
                     "from tests.synthetic_raw import", "import imageio"], found


NEW_MODULES = ("native/__init__.py", "config_hier.py", "utils/profile.py", "utils/raster.py",
               "tools/compare_psnr.py", "parallel/__init__.py", "parallel/dist.py",
               "utils/device_map.py", "tools/ddp_step.py", "utils/metrics.py",
               "preprocess/__init__.py", "preprocess/run.py",
               "preprocess/backends/__init__.py", "preprocess/backends/weights.py",
               "preprocess/backends/layers.py", "preprocess/backends/flow_classical.py",
               "preprocess/backends/flow_raft.py", "preprocess/backends/seg_unet.py",
               "preprocess/backends/seg_backends.py", "preprocess/backends/prompt_select.py",
               "preprocess/backends/depth_unet.py", "preprocess/backends/depth_backends.py",
               "preprocess/backends/feat_net.py", "preprocess/backends/feat_backends.py",
               "preprocess/backends/viewpoint_net.py", "preprocess/libs/__init__.py",
               "preprocess/libs/io.py", "preprocess/libs/geometry.py",
               "preprocess/libs/registration.py", "preprocess/scripts/__init__.py",
               "preprocess/scripts/extract_frames.py", "preprocess/scripts/frame_filter.py",
               "preprocess/scripts/write_config.py", "preprocess/scripts/download.py",
               "preprocess/scripts/manual_cameras.py", "preprocess/scripts/compute_flow.py",
               "preprocess/scripts/crop.py", "preprocess/scripts/camera_registration.py",
               "preprocess/scripts/tsdf_fusion.py",
               "preprocess/scripts/canonical_registration.py",
               "preprocess/scripts/extract_features.py",
               "scripts/__init__.py", "scripts/optim.py", "scripts/train_flow_raft.py",
               "scripts/train_seg_unet.py", "scripts/train_depth_unet.py",
               "scripts/train_feat_net.py", "scripts/train_viewpoint.py",
               "scripts/validate_adversarial.py", "scripts/render_intermediate.py",
               "scripts/create_collage.py", "scripts/run_rendering_parallel.py",
               "scripts/run_crop_all.py", "browser/__init__.py", "browser/app.py",
               "tools/synthetic_adversarial.py")


def test_scan_sees_every_module():
    assert len(SOURCES) > 30
    assert any(p.name == "trainer.py" for p in SOURCES)
    scanned = {p.relative_to(REPO / "lab4d_tpu_torch").as_posix() for p in SOURCES[:-1]}
    assert set(NEW_MODULES) <= scanned


_PROGRAM = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {forbidden!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
from lab4d_tpu_torch import config_hier, native, render, train
from lab4d_tpu_torch.tools import compare_psnr
from lab4d_tpu_torch.utils import device_map, metrics, profile, raster
from lab4d_tpu_torch.parallel import dist
from lab4d_tpu_torch.tools import ddp_step
from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset
from lab4d_tpu_torch.preprocess import run as preprocess_run
from lab4d_tpu_torch.preprocess.backends import flow_classical
from lab4d_tpu_torch.preprocess.scripts.tsdf_fusion import integrate
from lab4d_tpu_torch.scripts import (create_collage, render_intermediate, run_crop_all,
                                     run_rendering_parallel, train_depth_unet, train_feat_net,
                                     train_flow_raft, train_seg_unet, train_viewpoint,
                                     validate_adversarial)
from lab4d_tpu_torch.browser import app
from lab4d_tpu_torch.tools.synthetic_adversarial import make_adversarial_dataset
import numpy as np, torch
root = sys.argv[1]
train_depth_unet.main(steps=2, res=32, batch=1, out_path=root + '/w/depth_unet.msgpack',
                      device='cpu')
from lab4d_tpu_torch.preprocess.backends import depth_unet
assert depth_unet.load_model(path=root + '/w/depth_unet.msgpack') is not None
a = (np.random.default_rng(0).random((40, 40, 3)) * 255).astype(np.uint8)
fw, bw = flow_classical.compute_pair_flow(a, np.roll(a, 2, 1), res=32, device='cpu')
assert fw.shape == (32, 32, 3) and np.isfinite(fw).all()
vox = torch.rand(64, 3) - 0.5
s2c = torch.eye(4)[None].clone()
s2c[0, 2, 3] = 2.0
t, w = integrate(torch.ones(64), torch.zeros(64), vox, torch.full((1, 16, 16), 2.0),
                 torch.tensor([[16.0, 16.0, 8.0, 8.0]]), s2c, 0.1)
assert (w > 0).any() and torch.isfinite(t).all()
make_synthetic_dataset(root + '/database', seqname='iso', num_frames=8, res=16)
common = ['--seqname', 'iso', '--logname', 'r', '--train_res', '16', '--field_type', 'bg',
          '--device', 'cpu', '--database_root', root + '/database', '--logroot', root + '/logdir']
trainer = train.main(common + ['--num_rounds', '1', '--iters_per_round', '2',
                               '--imgs_per_gpu', '4', '--pixels_per_image', '4',
                               '--geo_init_steps', '2', '--save_freq', '1', '--eval_res', '4'])
assert trainer.current_steps == 2
assert native._lib is not None  # the batches came through the C++ sampler
out = render.main(common + ['--load_suffix', 'latest', '--render_res', '4', '--freeze_id', '0',
                            '--num_frames', '1'])
assert out['rgb'].shape == (1, 4, 4, 3)
loaded = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})
assert not loaded, loaded
loaded = sorted(m for m in sys.modules if m.split('.')[0] in {outside!r} + ('sklearn',))
assert not loaded, loaded
print('isolated ok')
"""


def test_train_and_render_without_jax(tmp_path):
    code = _PROGRAM.format(forbidden=PORT_FORBIDDEN, outside=OUTSIDE)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "isolated ok" in res.stdout
