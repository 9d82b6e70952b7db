"""The port's native batch sampler against the JAX package's.

- the gathers: lab4d_tpu_torch.native's C++ gather_pixels /
  gather_features_bilinear against the JAX package's library
  (lab4d_tpu/native/libsampler.so, loaded, never rebuilt in place: where
  its source is newer, a copy is built under tmp_path) and against the
  port's numpy references, over uint8, float16, float32 and bool sources
  and channel slices. Pixels equal exactly everywhere; the bilinear
  features equal the numpy reference exactly and JAX's library within
  1e-6 (that library was built with -march=native, which fuses products
  into multiply-adds: one rounding fewer);
- VidData.load_pairs_batch of both packages from identically seeded
  VidData.rng / idx_sampler, at 8 pixels and at 200 pixels of a 32^2 image
  (the RangeSampler refills inside the batch), with both of the port's
  gather backends: every key equal, `feature` within 1e-6;
- TrainBatchLoader._make_batch over two videos from one seed, equal to
  JAX's;
- a g++ that cannot run raises with the command instead of falling back.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from lab4d_tpu import native as jax_native
from lab4d_tpu.dataloader import data_utils as jax_data
from lab4d_tpu_torch import native
from lab4d_tpu_torch.dataloader import data_utils

FEATURE_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's sampler library, loaded as its get_lib loads it,
    without writing into lab4d_tpu/native/: where its get_lib would
    rebuild (source newer than the library), a copy built with its own
    command under a temporary directory is loaded instead."""
    lib_path = jax_native._LIB
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(jax_native._SRC):
        lib_path = str(tmp_path_factory.mktemp("jax_native") / "libsampler.so")
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
                        jax_native._SRC, "-o", lib_path], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", lib_path)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        mp.setattr(jax_native, "_build",
                   lambda: pytest.fail("the JAX package's library would be rebuilt in place"))
        lib = jax_native.get_lib()
        assert isinstance(lib, ctypes.CDLL)
        yield lib


def _pixels(rng, F, P, H, W):
    return np.stack([rng.integers(0, W, (F, P)), rng.integers(0, H, (F, P))], -1).astype(np.int32)


@pytest.mark.parametrize("dtype", ["uint8", "float16", "float32", "bool"])
@pytest.mark.parametrize("channels", [(0, None), (1, 3), (0, 1)])
def test_gather_pixels_matches_jax_and_reference(jax_lib, dtype, channels):
    rng = np.random.default_rng(1)
    src = (rng.random((6, 20, 24, 4)) * (1 if dtype == "bool" else 200)).round().astype(dtype)
    fids = rng.integers(0, 6, 9).astype(np.int32)
    xys = _pixels(rng, 9, 13, 20, 24)
    got = native.gather_pixels(src, fids, xys, *channels)
    assert got.dtype == np.float32 and got.shape[:2] == (9, 13)
    np.testing.assert_array_equal(got, jax_native.gather_pixels(src, fids, xys, *channels))
    np.testing.assert_array_equal(got, native.gather_pixels_reference(src, fids, xys, *channels))


def test_gather_pixels_of_a_frame_stack_without_channels(jax_lib):
    """(T, H, W) sources (depth) read as one channel."""
    rng = np.random.default_rng(2)
    src = rng.random((4, 16, 16)).astype(np.float32)
    fids, xys = rng.integers(0, 4, 5).astype(np.int32), _pixels(rng, 5, 7, 16, 16)
    got = native.gather_pixels(src, fids, xys)
    assert got.shape == (5, 7, 1)
    np.testing.assert_array_equal(got, jax_native.gather_pixels(src, fids, xys))
    np.testing.assert_array_equal(got, native.gather_pixels_reference(src, fids, xys))


@pytest.mark.parametrize("dtype", ["uint8", "float16", "float32"])
@pytest.mark.parametrize("feat_res,img_res", [(12, 20), (112, 32), (16, 16)])
def test_gather_features_bilinear_matches_jax_and_reference(jax_lib, dtype, feat_res, img_res):
    rng = np.random.default_rng(3)
    scale = 255 if dtype == "uint8" else 1
    src = (rng.standard_normal((5, feat_res, feat_res, 16)) * scale).astype(dtype)
    fids = rng.integers(0, 5, 6).astype(np.int32)
    xys = _pixels(rng, 6, 11, img_res, img_res)
    s = float(feat_res) / img_res
    got = native.gather_features_bilinear(src, fids, xys, s)
    np.testing.assert_array_equal(got, native.gather_features_bilinear_reference(src, fids, xys, s))
    want = jax_native.gather_features_bilinear(src, fids, xys, s)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL * max(1.0, np.abs(want).max()))


def test_unsupported_source_dtype_raises():
    src = np.zeros((2, 4, 4, 1), np.int64)
    with pytest.raises(TypeError):
        native.gather_pixels(src, np.zeros(1, np.int32), np.zeros((1, 2, 2), np.int32))


def test_failed_build_raises_with_the_command(monkeypatch, tmp_path):
    """No silent fallback: a compiler that cannot run raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        native.gather_pixels(np.zeros((1, 2, 2, 1), np.float32), np.zeros(1, np.int32),
                             np.zeros((1, 1, 2), np.int32))


def test_failed_compile_raises_with_stderr(monkeypatch, tmp_path):
    bad = tmp_path / "sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.get_lib()


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        native.backend("cuda")


# ------------------------------------------------------------ the batches


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tests.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("db")
    make_synthetic_dataset(str(root), seqname="sampler", num_vids=2, num_frames=12, res=32)
    return str(root)


def _datasets(module, scene, pixels):
    """config_to_datasets of `module`, each video's draws seeded alike."""
    opts = dict(seqname="sampler", data_prefix="crop", train_res=32, feature_type="dinov2",
                pixels_per_image=pixels, database_root=scene)
    datasets = module.config_to_datasets(opts)
    for i, ds in enumerate(datasets):
        ds.rng = np.random.default_rng(100 + i)
        ds.idx_sampler.rng = ds.rng
        ds.idx_sampler._refill()
    return datasets


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k == "feature":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FEATURE_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("gather", ["native", "reference"])
@pytest.mark.parametrize("pixels", [8, 200])
def test_load_pairs_batch_matches_jax(jax_lib, scene, gather, pixels):
    """Three batches in a row from identically seeded draws. At 200 px of
    32^2 = 1024 the RangeSampler refills inside the second batch (8 pixel
    sets of 200)."""
    ours, theirs = _datasets(data_utils, scene, pixels), _datasets(jax_data, scene, pixels)
    for indices in ([0, 3, 5, 8], [1, 2, 4, 6], [0, 8, 9, 10]):
        for vid in (0, 1):
            _assert_batches_equal(ours[vid].load_pairs_batch(indices, gather=gather),
                                  theirs[vid].load_pairs_batch(indices))
    assert ours[0].idx_sampler.curr == theirs[0].idx_sampler.curr


def test_load_pairs_batch_keeps_load_pairs_contract(scene):
    """The batched pairs hold the keys, shapes and dtypes of load_pair."""
    ds = _datasets(data_utils, scene, 8)[0]
    batch = ds.load_pairs_batch([0, 4])
    single = ds.load_pair(2)
    assert set(batch) == set(single)
    for k, v in single.items():
        assert batch[k].shape == (2,) + np.shape(v), k
        assert batch[k].dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_over_two_videos_matches_jax(jax_lib, scene, seed):
    ours = data_utils.TrainBatchLoader(_datasets(data_utils, scene, 16), imgs_per_batch=12)
    theirs = jax_data.TrainBatchLoader(_datasets(jax_data, scene, 16), imgs_per_batch=12)
    rng_ours, rng_theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        got, want = ours._make_batch(rng_ours), theirs._make_batch(rng_theirs)
        assert set(np.unique(got["dataid"])) == {0, 1}
        _assert_batches_equal(got, want)
    np.testing.assert_array_equal(ours._pick_pairs(np.random.default_rng(3)),
                                  theirs._pick_pairs(np.random.default_rng(3)))


def test_config_to_datasets_defaults_to_training(scene):
    """is_eval=False by default, as in the JAX package: flow deltas {1, 2,
    4, 8} and pixels_per_image pixels."""
    opts = dict(seqname="sampler", data_prefix="crop", train_res=32, feature_type="dinov2",
                pixels_per_image=8, database_root=scene)
    train = data_utils.config_to_datasets(opts)
    assert train[0].delta_list == [2, 4, 8] and train[0].pixels_per_image == 8
    ev = data_utils.config_to_datasets(opts, is_eval=True)
    assert ev[0].delta_list == [] and ev[0].pixels_per_image == -1
