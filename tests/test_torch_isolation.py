"""The port stands alone: nothing under lab4d_tpu_torch/, and not
chip_smoke.py, imports jax, flax or the JAX package (lab4d_tpu), not even
a module of it that has no JAX in it; the card that runs the port has
none of them.

- an AST scan of every import statement, and of every string literal
  for import statements and dotted lab4d_tpu module names (a program
  kept in a string and run in a child interpreter imports too);
- a fresh interpreter in which those modules cannot be imported trains
  the bg field for two steps on the CPU (synthetic scene, prior fits,
  batches through the native sampler, the round's eval render, checkpoint)
  and renders it, imports the flag schema, the profiling, raster and
  PSNR-comparison modules, and then holds none of them in sys.modules.
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
    bad = [(line, name) for line, name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# a program kept in a string (run with `python -c` or exec) imports too
_IMPORT_IN_TEXT = re.compile(
    r"\bimport\s+(jax|jaxlib|flax|lab4d_tpu)\b(?![/_])"
    r"|\bfrom\s+(jax|jaxlib|flax|lab4d_tpu)(\.\w+)*\s+import\b"
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
                   'MOD = "lab4d_tpu.engine.trainer"\n')
    found = [text for _, text in _imports_in_strings(src)]
    assert found == ["import jax", "from lab4d_tpu.config import", "lab4d_tpu.e"], found


NEW_MODULES = ("native/__init__.py", "config_hier.py", "utils/profile.py", "utils/raster.py",
               "tools/compare_psnr.py")


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
from lab4d_tpu_torch.utils import profile, raster
from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset
root = sys.argv[1]
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
print('isolated ok')
"""


def test_train_and_render_without_jax(tmp_path):
    code = _PROGRAM.format(forbidden=FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "isolated ok" in res.stdout
