"""Training over ranks (parallel/dist.py): the port's sharded step against
its one-process step on the same global batch, params and draws, and
against the JAX package's sharded step; the loader's global batch over
shards; the device map. The train CLI over two gloo workers is in
tests/test_torch_ddp_cli.py.

The sharded steps run in processes spawned here (gloo on the CPU,
tools/ddp_step.py run_sharded), on make_model_and_batch's batch at M=8
pairs, N=4 pixels:
- the flagship fg / skel-quad step at world size 4 (data=4), against the
  JAX step on a ("data",) mesh of 4 of the host's 8 devices;
- the category step (--nosingle_inst, skel-quad, 4 videos) at data=2 x
  video=2, its batch's block j drawn from the videos of group j % 2 (the
  loader's rule), against the JAX step on a ("data", "video") = (2, 2)
  mesh with the per-video tables sharded over "video".
Loss terms are held to 2e-4 |s| + |s| / npix + 1e-9 (one flip of a
nonzero-mean count, as tests/test_sharding.py allows JAX); gradients and
the AdamW update as ddp_step.compare states (a term that used its flip
allowance widens each gradient bound by max |g| / npix); the ranks' param
checksums must be equal after the update. The draws are given at the
global batch's shape (numpy; JAX's through jax.random in its call
order); one more run draws them from torch's generators at the same seed
on both sides.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu.dataloader import data_utils as jdata
from lab4d_tpu.engine.model import DVRModel as JaxDVRModel
from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from lab4d_tpu.nnutils.embedding import FrameInfo as JaxFrameInfo
from lab4d_tpu.parallel import mesh_utils
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.dataloader import data_utils as pdata
from lab4d_tpu_torch.parallel import dist
from lab4d_tpu_torch.tools import ddp_step
from lab4d_tpu_torch.utils.device_map import device_map
from tests.test_model import (LOSS_WEIGHTS, RNGS, init_params_with_intrinsics_prior,
                              make_model_and_batch)
from tests.test_torch_families import SKINNING, jax_draw_order
from tests.test_torch_native_sampler import _assert_batches_equal, jax_lib  # noqa: F401

torch.set_num_threads(1)  # as tests/test_torch_families.py

M, N, STEP = 8, 4, 100
NPIX = M * N
# the category case: four videos of 5 filtered frames (6 raw frames) each
CAT_OFFSET, CAT_OFFSET_RAW = [0, 5, 10, 15, 20], [0, 6, 12, 18, 24]
CAT_MAPPING = [v * 6 + i for v in range(4) for i in range(5)]


def global_draws(fg_motion, num_inst, seed=7):
    """The step's draws at the global batch's shape, from numpy (keyed by
    the port's names; JAX's call order in tests/test_torch_families.py)."""
    rng = np.random.default_rng(seed)
    rays = 2 * M * N
    d = {
        "eikonal_idx": rng.permutation(rays)[: rays // 16],
        "match_idx": rng.integers(0, rays * 64, 1024),
        "vis_u": rng.random((512, 3)).astype(np.float32),
        "vis_inst": rng.integers(0, num_inst, 512),
    }
    if fg_motion in SKINNING:
        d["gauss_u"] = rng.random((2048, 3)).astype(np.float32)
    if num_inst > 1:  # the base and colour MLPs' code swaps, one row each
        d["swap"] = [(rng.integers(0, num_inst, 2 * M), rng.random(2 * M).astype(np.float32))
                     for _ in range(2)]
    return {"fg": d}


def flagship():
    jmodel, batch = make_model_and_batch("fg", "skel-quad", M=M, N=N)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    return jmodel, batch, params, global_draws("skel-quad", 1)


def category():
    """4 videos, one instance each; pair block j (of 4) from the videos of
    group j % 2, as TrainBatchLoader(total_shards=4, video_shards=2) draws."""
    _, batch = make_model_and_batch("fg", "skel-quad", M=M, N=N)
    fi = JaxFrameInfo(CAT_OFFSET, CAT_OFFSET_RAW, CAT_MAPPING)
    nf = len(CAT_MAPPING)
    rt = np.tile(np.eye(4, dtype=np.float32)[None], (nf, 1, 1))
    rt[:, 2, 3] = 1.0
    intr = np.tile(np.array([100.0, 100.0, 32.0, 32.0], np.float32)[None], (nf, 1))
    jmodel = JaxDVRModel(frame_info=fi, field_type="fg", fg_motion="skel-quad", num_inst=4,
                         train_res=64, intrinsics_init=intr, rtmat_fg=rt, rtmat_bg=rt,
                         loss_weights=LOSS_WEIGHTS)
    rng = np.random.default_rng(3)
    vids = np.array([j % 2 + 2 * (i % 2) for j in range(4) for i in range(M // 4)])
    batch = dict(batch)
    batch["dataid"] = jnp.asarray(np.repeat(vids[:, None], 2, 1).astype(np.int32))
    batch["frameid_sub"] = jnp.asarray(rng.integers(0, 5, (M, 2)).astype(np.int32))
    batch["geo"] = {"fg": dict(batch["geo"]["fg"], near_far_table=jnp.tile(
        jnp.asarray([0.5, 2.0], jnp.float32), (CAT_OFFSET_RAW[-1], 1)))}
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    return jmodel, batch, params, global_draws("skel-quad", 4)


def write_case(path, jmodel, batch, params, draws):
    fi = jmodel.frame_info
    ddp_step.save_case(
        path, fi,
        {"field_type": "fg", "fg_motion": jmodel.fg_motion, "num_inst": jmodel.num_inst,
         "intrinsics_init": np.asarray(jmodel.intrinsics_init), "rtmat_fg": jmodel.rtmat_fg,
         "rtmat_bg": jmodel.rtmat_bg, "train_res": jmodel.train_res,
         "loss_weights": LOSS_WEIGHTS},
        {k: v.numpy() for k, v in bridge.params_from_flax(
            jax.tree.map(np.asarray, params)).items()},
        {k: np.asarray(v) for k, v in batch.items() if k != "geo"},
        {c: {k: np.asarray(v) for k, v in g.items()} for c, g in batch["geo"].items()},
        STEP, draws=draws)


def jax_sharded_loss(jmodel, batch, params, draws, data, video):
    """The JAX training forward's loss terms on a ("data", "video") mesh,
    the batch's leading axis over both, the per-video tables over "video",
    the draws replaced by `draws` in JAX's call order."""
    queues = {}
    for name, arr in jax_draw_order(draws):
        queues.setdefault((name, arr.shape), []).append(arr)

    def fake(name, shape_arg):
        orig = getattr(jax.random, name)

        def f(*args, **kwargs):
            shape = kwargs.get("shape", args[shape_arg] if len(args) > shape_arg else None)
            q = None if shape is None else queues.get((name, tuple(shape)))
            if not q or (name == "uniform" and len(args) > 2):
                return orig(*args, **kwargs)
            return jnp.asarray(q.pop(0))
        return f

    mesh = mesh_utils.make_mesh(data, video, jax.devices()[:data * video])
    sched = jax_compute_sched(STEP)
    placed = {k: jax.device_put(v, mesh_utils.batch_sharding(mesh))
              for k, v in batch.items() if k != "geo"}
    placed["geo"] = jax.device_put(batch["geo"], mesh_utils.replicated(mesh))
    p = jax.device_put(params, mesh_utils.param_shardings(mesh, params,
                                                          jmodel.frame_info.num_vids))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "choice", fake("choice", 2))
    mp.setattr(jax.random, "uniform", fake("uniform", 1))
    mp.setattr(jax.random, "randint", fake("randint", 1))
    try:
        ld = jax.jit(lambda pp, b: jmodel.apply({"params": pp}, b, sched, train=True,
                                                rngs=RNGS))(p, placed)
    finally:
        mp.undo()
    assert all(not q for q in queues.values()), "JAX drew fewer times than expected"
    return {k: float(v) for k, v in ld.items()}


CASES = {"fg-data4": (flagship, 4, 1), "category-data2x2": (category, 2, 2)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    build, data, video = CASES[request.param]
    jmodel, batch, params, draws = build()
    path = str(tmp_path_factory.mktemp("ddp") / "case.pt")
    write_case(path, jmodel, batch, params, draws)
    one = ddp_step.run_case(ddp_step.load_case(path), "cpu")
    sharded = ddp_step.run_sharded(path, data * video)
    return {"one": one, "sharded": sharded, "path": path,
            "jax": jax_sharded_loss(jmodel, batch, params, draws, data, video)}


def test_loss_terms_match_the_one_process_step(case):
    one, sharded = case["one"]["loss"], case["sharded"]["loss"]
    assert sorted(one) == sorted(sharded)
    assert len(one) >= 17  # 17 terms and the total
    for k, s in one.items():
        assert abs(sharded[k] - s) <= ddp_step.term_bound(s, NPIX), (k, sharded[k], s)
    assert case["one"]["gnorm"] < 5.0  # the update is taken, not skipped


def test_gradients_and_update_match_the_one_process_step(case):
    res = ddp_step.compare(case["one"], case["sharded"], NPIX)
    assert not res["fails"], res
    # every gradient is compared, and the updates moved the params
    assert set(case["sharded"]["grads"]) == set(case["one"]["grads"])
    assert max(np.abs(g).max() for g in case["one"]["grads"].values()) > 0


def test_loss_terms_match_the_jax_sharded_step(case):
    want, got = case["jax"], case["sharded"]["loss"]
    assert sorted(want) == sorted(k for k in got if k != "total")
    for k, s in want.items():
        if k != "reg_soft_deform":  # zero for a skeleton warp
            assert s > 0, k
        assert abs(got[k] - s) <= ddp_step.term_bound(s, NPIX), (k, got[k], s)


def test_rank_checksums_agree(case):
    cs = case["sharded"]["checksums"]
    assert len(cs) == 4 and len(set(cs)) == 1, cs


def test_draws_from_the_generators_at_the_global_shape(tmp_path):
    """Without injected draws, the ranks draw the eikonal rays, the match
    candidates and the regularizers' points from torch's generators at the
    global batch's shape, as the one-process step does from the same seed:
    the same step."""
    jmodel, batch, params, _ = flagship()
    path = str(tmp_path / "case.pt")
    write_case(path, jmodel, batch, params, None)
    one = ddp_step.run_case(ddp_step.load_case(path), "cpu")
    sharded = ddp_step.run_sharded(path, 2)
    res = ddp_step.compare(one, sharded, NPIX)
    assert not res["fails"], res


# ------------------------------------------------------------- the loader


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tests.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("scene")
    make_synthetic_dataset(str(root / "database"), seqname="ddp", num_vids=4, num_frames=6,
                           res=16)
    return str(root / "database")


def _datasets(pkg, db):
    """config_to_datasets of `pkg`, each video's pixel draws seeded alike."""
    opts = {"seqname": "ddp", "database_root": db, "data_prefix": "crop", "train_res": 16,
            "feature_type": "dinov2", "pixels_per_image": 8}
    datasets = pkg.config_to_datasets(opts)
    for i, ds in enumerate(datasets):
        ds.rng = np.random.default_rng(100 + i)
        ds.idx_sampler.rng = ds.rng
        ds.idx_sampler._refill()
    return datasets


def test_loader_global_batch_matches_jax_over_shards(jax_lib, scene):
    """TrainBatchLoader(total_shards=4, video_shards=2) draws JAX's global
    batch from the same seeds (bit for bit but the features, held as
    tests/test_torch_native_sampler.py holds them), block j from video
    group j % 2; rank r trains on block r."""
    ours = pdata.TrainBatchLoader(_datasets(pdata, scene), imgs_per_batch=16, total_shards=4,
                                  video_shards=2)
    theirs = jdata.TrainBatchLoader(_datasets(jdata, scene), imgs_per_batch=16, total_shards=4,
                                    video_shards=2)
    rng_ours, rng_theirs = np.random.default_rng(5), np.random.default_rng(5)
    seen = set()
    for _ in range(2):
        got = ours._make_batch(rng_ours)
        _assert_batches_equal(got, theirs._make_batch(rng_theirs))
        for r in range(4):
            rows = dist.batch_block(got, r, 4)
            np.testing.assert_array_equal(rows["dataid"], got["dataid"][4 * r:4 * r + 4])
            assert np.all(rows["dataid"] % 2 == r % 2)
        seen |= set(np.unique(got["dataid"]).tolist())
    assert seen == {0, 1, 2, 3}


def test_loader_sequence_is_the_same_in_every_run(scene):
    """Two worker threads, whichever finishes first: every rank's loader
    hands out the same sequence of global batches."""
    def first_batches(n):
        loader = pdata.TrainBatchLoader(_datasets(pdata, scene), imgs_per_batch=4,
                                        num_workers=2, seed=3)
        try:
            return [loader.next_batch()["frameid_sub"] for _ in range(n)]
        finally:
            loader.stop()

    a, b = first_batches(6), first_batches(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_video_shards_must_split_the_batch(scene):
    with pytest.raises(ValueError, match="do not split"):
        pdata.TrainBatchLoader(_datasets(pdata, scene), imgs_per_batch=6, total_shards=4)


# ------------------------------------------------------- helpers, device map


def test_block_of_a_global_batch():
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(dist.block(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        dist.block(x, 0, 4)
    # outside a process group every helper acts on the local tensors
    t = torch.ones(3)
    assert dist.world_size() == 1 and dist.batch_shards() == (0, 1)
    assert dist.global_sum(t) is t
    assert dist.all_gather(t).shape == (1, 3)


def test_per_video_tokens_are_jaxs():
    assert dist.PER_VIDEO_PARAM_TOKENS == mesh_utils.PER_VIDEO_PARAM_TOKENS


def test_device_map_pins_one_card_per_worker():
    got = device_map(os.getenv, [("CUDA_VISIBLE_DEVICES",)] * 4, devices=[0, 1])
    assert got == ["0", "1", "0", "1"]
    got = device_map(os.getenv, [("CUDA_VISIBLE_DEVICES",)] * 2, devices=[0, 1],
                     method="dynamic")
    assert sorted(got) == ["0", "1"]


def _rollback_rank(rank, case_path, init, out):
    """One rank: a step, then check_grad's rollback to the cache taken
    before it; the round-end sync check; the params' checksum."""
    torch.set_num_threads(1)
    torch.manual_seed(1)  # as the trainer seeds each round over ranks (spawn seeds at random)
    dist.init_distributed("cpu", init, 2, rank)
    try:
        case = ddp_step.load_case(case_path)
        trainer = ddp_step.build_trainer(case, "cpu")
        trainer.model_cache = [{k: v.detach().clone()
                                for k, v in trainer.model.state_dict().items()}, None]
        trainer.opt_cache = [trainer.optimizer.state_dict(), None]
        before = dist.checksum(list(trainer.model.parameters()))
        batch = {k: torch.as_tensor(v) for k, v in dist.batch_block(case["batch"], rank, 2).items()}
        batch["geo"] = {c: {k: torch.as_tensor(v) for k, v in g.items()}
                        for c, g in case["geo"].items()}
        trainer.train_step(batch, case["step"], draws=ddp_step._draws_to(case["draws"], "cpu"))
        moved = dist.checksum(list(trainer.model.parameters()))
        trainer.check_grad(float("inf"))  # a spike: every rank rolls back
        trainer.check_in_sync()
        torch.save([before, moved, dist.checksum(list(trainer.model.parameters()))],
                   f"{out}.{rank}")
    finally:
        dist.shutdown()


def test_ranks_agree_after_a_rollback(case, tmp_path):
    """A non-finite grad norm, which every rank reads alike (the summed
    gradient's), rolls every rank back to the same cached params."""
    import torch.multiprocessing as mp

    out = str(tmp_path / "sums")
    mp.start_processes(_rollback_rank, nprocs=2, start_method="spawn",
                       args=(case["path"], f"tcp://localhost:{dist.free_port()}", out))
    sums = [torch.load(f"{out}.{r}") for r in range(2)]
    assert sums[0] == sums[1]
    before, moved, after = sums[0]
    assert moved != before and after == before
