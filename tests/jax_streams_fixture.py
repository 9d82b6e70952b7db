"""The [streams] fixture from JAX: tests/data/jax_streams.npz holds, for
each entry of lab4d_tpu_torch/engine/jax_streams.py FIXTURE_SPEC, what
JAX 0.9 and flax 0.12 give: flax's scope keys (_fold_in_static), the
flagship fg / skel-quad model's first training step's draws and its prior
fit's first eikonal rays (jax.random on those keys, as lab4d_tpu's
modules call it), the first values of a leaf of the flagship's
model.init at PRNGKey(0) per initializer kind and of the viewpoint net's
init, and a category swap draw. chip_smoke.py [streams] holds the port's
replica against it on the card's host, where there is no JAX.

    JAX_PLATFORMS=cpu python -m tests.jax_streams_fixture   # rewrites the file
"""

from __future__ import annotations

import json
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jax_streams.npz")


def jax_values(spec):
    import jax
    from flax.core.scope import _fold_in_static

    from lab4d_tpu.engine.schedules import compute_sched
    from lab4d_tpu.nnutils.linear import torch_linear_init
    from tests.test_model import RNGS, make_model_and_batch
    from tests.test_torch_train_viewpoint import _flax_params

    step = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    aux, swap = jax.random.split(step)
    roots = {"params": jax.random.PRNGKey(0), "aux0": aux, "swap0": swap,
             "fit0": jax.random.fold_in(jax.random.PRNGKey(7), 0)}
    model, batch = make_model_and_batch("fg", "skel-quad", M=2, N=4)
    params = jax.jit(model.init, static_argnames=("train",))(RNGS, batch, compute_sched(0),
                                                            train=True)["params"]
    out = {}
    for name, kind, root, path, count, *rest in spec:
        root = roots[root]
        key = lambda n: _fold_in_static(root, tuple(path) + (n,))  # noqa: E731
        if kind == "key":
            out[name] = key(count)
        elif kind == "step":  # nerf.py compute_eikonal, feature.py global_match, ...
            r1, r2 = jax.random.split(key(3))
            draws = {"eikonal_idx": jax.random.choice(key(1), count, (count // 16,),
                                                      replace=False),
                     "match_idx": jax.random.randint(key(2), (1024,), 0, count * 64),
                     "vis_u": jax.random.uniform(r1, (512, 3)),
                     "vis_inst": jax.random.randint(r2, (512,), 0, 1),
                     "gauss_u": jax.random.uniform(key(4), (2048, 3))}
            out.update({f"{name}/{k}": v for k, v in draws.items()})
        elif kind == "fit":
            out[name] = jax.random.choice(key(1), count, (count // 16,), replace=False)
        elif kind == "swap":  # embedding.py InstEmbedding
            (rows,), num_inst = rest
            r_id, r_mask = jax.random.split(key(count))
            out[name + "/rand_id"] = jax.random.randint(r_id, (rows,), 0, num_inst)
            out[name + "/u"] = jax.random.uniform(r_mask, (rows,))
        elif kind == "lecun":  # the viewpoint net's first conv at its trainer's init
            out[name] = np.asarray(_flax_params()["Conv_0"]["kernel"]).reshape(-1)[:16]
        else:  # the flagship's model.init at PRNGKey(0)
            node = params
            for p in path[:-1] if kind == "embed" else path:
                node = node[p]
            leaf = node["mapping"]["embedding"] if kind == "embed" else node["linear_1"]
            if kind == "uniform":  # the initializer itself, on the leaf's key, too
                shape, fan_in = rest
                np.testing.assert_array_equal(
                    np.asarray(torch_linear_init(fan_in)(key(count), shape)), np.asarray(leaf))
            out[name] = np.asarray(leaf).reshape(-1)[:16]
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lab4d_tpu_torch.engine.jax_streams import FIXTURE_SPEC

    values = jax_values(FIXTURE_SPEC)
    values["spec"] = np.asarray(json.dumps(FIXTURE_SPEC))
    values["versions"] = np.asarray(json.dumps({"jax": jax.__version__}))
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **values)
    print(f"wrote {PATH}: {len(values)} arrays")


if __name__ == "__main__":
    main()
