"""The port's training logger (engine/trainer.py make_logger) against the
JAX trainer's _make_logger.

- the same scalar and image calls through both loggers write the same
  metrics.jsonl lines, byte for byte;
- the TensorBoard event files hold the same scalar tags, steps and values
  (read back with tensorboardX.proto.event_pb2) and the same `img_<key>`
  image tags at the same steps (the PNG encodings are not compared);
- with the tensorboardX import blocked both write JSONL only.
"""

import builtins
import glob
import json
import os
import struct

import numpy as np
import pytest

from lab4d_tpu.engine.trainer import _make_logger as jax_logger
from lab4d_tpu_torch.engine.trainer import make_logger

SCALARS = [
    ({"eval/psnr": 21.5, "eval/ssim": 0.75, "eval/depth_err": 0.125}, 0),
    ({"grad_norm": 0.25, "mask": 0.0625, "rgb": 0.5, "total": 1.0}, 10),
    ({"grad_norm": 0.5, "mask": 0.03125, "rgb": 0.25, "total": 0.75}, 20),
]


def _rendered():
    rng = np.random.default_rng(0)
    return {"rgb": rng.random((4, 8, 8, 3)).astype(np.float32),
            "mask": rng.random((4, 8, 8, 1)).astype(np.float32),
            "depth": rng.random((4, 8, 8, 1)).astype(np.float32)}


def _drive(logger):
    logger.images(_rendered(), 0)
    for d, step in SCALARS:
        logger.scalars(d, step)
    logger.jsonl.flush()
    if logger.tb:
        logger.tb.close()  # the event writer's queue drained to disk


def _events(run_dir):
    """(scalars [(tag, step, value)], image tags [(tag, step)]) of the
    event files under run_dir."""
    from tensorboardX.proto import event_pb2

    scalars, images = [], []
    for path in sorted(glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))):
        data = open(path, "rb").read()
        pos = 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 12 + length + 4
            for v in event.summary.value:
                if v.HasField("image"):
                    images.append((v.tag, event.step))
                else:
                    scalars.append((v.tag, event.step, v.simple_value))
    return scalars, images


@pytest.fixture
def runs(tmp_path):
    pytest.importorskip("tensorboardX")
    out = {}
    for name, cls in (("jax", jax_logger), ("torch", make_logger)):
        run_dir = tmp_path / name
        run_dir.mkdir()
        logger = cls(str(run_dir))
        assert logger.tb is not None
        _drive(logger)
        out[name] = str(run_dir)
    return out


def test_metrics_jsonl_lines_equal(runs):
    lines = {k: open(os.path.join(d, "metrics.jsonl")).read() for k, d in runs.items()}
    assert lines["torch"] == lines["jax"]
    records = [json.loads(line) for line in lines["torch"].splitlines()]
    assert [r["step"] for r in records] == [0, 10, 20]


def test_event_scalars_equal(runs):
    got, want = _events(runs["torch"]), _events(runs["jax"])
    assert got[0] == want[0]
    assert ("eval/psnr", 0, 21.5) in got[0] and ("total", 20, 0.75) in got[0]


def test_event_image_tags_equal(runs):
    got, want = _events(runs["torch"]), _events(runs["jax"])
    assert sorted(got[1]) == sorted(want[1])
    assert {t for t, _ in got[1]} == {"img_rgb", "img_mask", "img_depth"}


def test_jsonl_only_without_tensorboardx(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name.split(".")[0] == "tensorboardX":
            raise ImportError("blocked: " + name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", blocked)
    lines = {}
    for name, cls in (("jax", jax_logger), ("torch", make_logger)):
        run_dir = tmp_path / name
        run_dir.mkdir()
        logger = cls(str(run_dir))
        assert logger.tb is None
        _drive(logger)
        assert os.listdir(run_dir) == ["metrics.jsonl"]
        lines[name] = open(run_dir / "metrics.jsonl").read()
    assert lines["torch"] == lines["jax"]


def test_close_flushes_and_closes(tmp_path):
    logger = make_logger(str(tmp_path))
    logger.scalars({"a": 1.0}, 3)
    logger.close()
    assert logger.jsonl.closed
    assert json.loads(open(tmp_path / "metrics.jsonl").read()) == {"step": 3, "a": 1.0}
