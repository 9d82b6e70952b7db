"""Port parity of the math layer: quaternion / dual-quaternion algebra,
geometry helpers, quad-skeleton FK and the volume-rendering primitives,
torch (lab4d_tpu_torch) against the JAX package on the same numpy inputs.

Cases follow tests/test_quat.py, test_geom.py and test_skinning_quad.py.
Tolerance: both sides evaluate the same fp32 formulas, so they differ by
a few ulps of the O(1) values; atol 1e-5 unless a case says otherwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu.ops import renderer as JR
from lab4d_tpu.utils import geom as JG
from lab4d_tpu.utils import quat as JQ
from lab4d_tpu.utils import skel as JS
from lab4d_tpu_torch.ops import renderer as TR
from lab4d_tpu_torch.utils import geom as TG
from lab4d_tpu_torch.utils import quat as TQ
from lab4d_tpu_torch.utils import skel as TS

ATOL = 1e-5


def rand_quat(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def rand_dq(n, seed):
    q, t = rand_quat(n, seed), rand((n, 3), seed + 1, 0.2)
    qd = np.asarray(JQ.quaternion_translation_to_dual_quaternion(jnp.asarray(q), jnp.asarray(t))[1])
    return q, qd


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [l for v in x for l in _leaves(v)]
    return [np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)]


def run_both(name, args):
    jf, tf = FUNCS[name]
    got = _leaves(tf(*[torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]))
    want = _leaves(jf(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    return got, want


FUNCS = {
    "quaternion_mul": (JQ.quaternion_mul, TQ.quaternion_mul),
    "quaternion_apply": (JQ.quaternion_apply, TQ.quaternion_apply),
    "quaternion_conjugate": (JQ.quaternion_conjugate, TQ.quaternion_conjugate),
    "quaternion_to_matrix": (JQ.quaternion_to_matrix, TQ.quaternion_to_matrix),
    "matrix_to_quaternion": (JQ.matrix_to_quaternion, TQ.matrix_to_quaternion),
    "axis_angle_to_quaternion": (JQ.axis_angle_to_quaternion, TQ.axis_angle_to_quaternion),
    "quaternion_translation_inverse": (
        JQ.quaternion_translation_inverse, TQ.quaternion_translation_inverse),
    "quaternion_translation_to_se3": (
        JQ.quaternion_translation_to_se3, TQ.quaternion_translation_to_se3),
    "se3_to_quaternion_translation": (
        JQ.se3_to_quaternion_translation, TQ.se3_to_quaternion_translation),
    "quaternion_translation_to_dual_quaternion": (
        JQ.quaternion_translation_to_dual_quaternion,
        TQ.quaternion_translation_to_dual_quaternion),
    "dual_quaternion_to_quaternion_translation": (
        lambda a, b: JQ.dual_quaternion_to_quaternion_translation((a, b)),
        lambda a, b: TQ.dual_quaternion_to_quaternion_translation((a, b))),
    "dual_quaternion_mul": (
        lambda a, b, c, d: JQ.dual_quaternion_mul((a, b), (c, d)),
        lambda a, b, c, d: TQ.dual_quaternion_mul((a, b), (c, d))),
    "dual_quaternion_inverse": (
        lambda a, b: JQ.dual_quaternion_inverse((a, b)),
        lambda a, b: TQ.dual_quaternion_inverse((a, b))),
    "K2mat": (JG.K2mat, TG.K2mat),
    "K2inv": (JG.K2inv, TG.K2inv),
    "mat2K": (JG.mat2K, TG.mat2K),
    "pinhole_projection": (JG.pinhole_projection, TG.pinhole_projection),
    "safe_norm": (JG.safe_norm, TG.safe_norm),
    "get_near_far": (JG.get_near_far, TG.get_near_far),
    "extend_aabb": (JG.extend_aabb, TG.extend_aabb),
    "check_inside_aabb": (JG.check_inside_aabb, TG.check_inside_aabb),
    "get_xyz_bone_distance": (
        lambda p, a, b: JG.get_xyz_bone_distance(p, (a, b)),
        lambda p, a, b: TG.get_xyz_bone_distance(p, (a, b))),
    "dual_quaternion_skinning": (
        lambda a, b, p, s: JG.dual_quaternion_skinning((a, b), p, s),
        lambda a, b, p, s: TG.dual_quaternion_skinning((a, b), p, s)),
    "compute_weights": (JR.compute_weights, TR.compute_weights),
    "sample_cam_rays": (
        lambda h, k, nf: JR.sample_cam_rays(h, k, nf, n_depth=16),
        lambda h, k, nf: TR.sample_cam_rays(h, k, nf, n_depth=16)),
    "sample_pdf": (
        lambda b, w: JR.sample_pdf(b, w, 32, det=True),
        lambda b, w: TR.sample_pdf(b, w, 32)),
}


def _skin(seed, M=2, P=40, B=7):
    logits = rand((M, P, B), seed, 3.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _pdf_case():
    bins = np.tile(np.linspace(0, 1, 31, dtype=np.float32)[None], (4, 1))
    w = np.full((4, 30), 1e-4, np.float32)
    w[:, 10:15] = 1.0
    w[1] = np.random.default_rng(3).random(30)
    return bins, w


CASES = {
    "quaternion_mul": lambda: (rand_quat(32, 0), rand_quat(32, 1)),
    "quaternion_apply": lambda: (rand_quat(16, 0), rand((16, 3), 2)),
    "quaternion_conjugate": lambda: (rand_quat(16, 4),),
    "quaternion_to_matrix": lambda: (rand_quat(64, 6),),
    "matrix_to_quaternion": lambda: (
        np.asarray(JQ.quaternion_to_matrix(jnp.asarray(rand_quat(64, 7)))),),
    "axis_angle_to_quaternion": lambda: (
        np.concatenate([rand((16, 3), 8), np.zeros((2, 3), np.float32),
                        rand((2, 3), 9, 1e-8)]),),
    "quaternion_translation_inverse": lambda: (rand_quat(16, 10), rand((16, 3), 11)),
    "quaternion_translation_to_se3": lambda: (rand_quat(8, 16), rand((8, 3), 17)),
    "se3_to_quaternion_translation": lambda: (
        np.asarray(JQ.quaternion_translation_to_se3(
            jnp.asarray(rand_quat(8, 18)), jnp.asarray(rand((8, 3), 19)))),),
    "quaternion_translation_to_dual_quaternion": lambda: (rand_quat(8, 20), rand((8, 3), 21)),
    "dual_quaternion_to_quaternion_translation": lambda: rand_dq(8, 22),
    "dual_quaternion_mul": lambda: rand_dq(8, 24) + rand_dq(8, 26),
    "dual_quaternion_inverse": lambda: rand_dq(8, 28),
    "K2mat": lambda: (np.abs(rand((5, 4), 33)) + 1,),
    "K2inv": lambda: (np.abs(rand((5, 4), 34)) + 1,),
    "mat2K": lambda: (np.asarray(JG.K2mat(jnp.asarray(np.abs(rand((5, 4), 35)) + 1))),),
    "pinhole_projection": lambda: (
        np.asarray(JG.K2mat(jnp.asarray(np.abs(rand((3, 4), 37)) * 50 + 10))),
        rand((3, 4, 5, 3), 38) + np.array([0, 0, 3], np.float32)),
    "safe_norm": lambda: (np.concatenate([rand((6, 3), 39), np.zeros((1, 3), np.float32)]),),
    "get_near_far": lambda: (rand((64, 3), 40), np.asarray(
        JQ.quaternion_translation_to_se3(jnp.asarray(rand_quat(4, 41)),
                                         jnp.asarray(rand((4, 3), 42) + [0, 0, 5])))),
    "extend_aabb": lambda: (np.array([[-0.2, -0.1, -0.3], [0.2, 0.4, 0.1]], np.float32),),
    "check_inside_aabb": lambda: (
        rand((4, 50, 3), 43, 0.3), np.array([[-0.2, -0.1, -0.3], [0.2, 0.4, 0.1]], np.float32)),
    "get_xyz_bone_distance": lambda: (rand((2, 5, 7, 3), 44),) + tuple(
        a.reshape(2, 4, 4) for a in rand_dq(8, 45)),
    "dual_quaternion_skinning": lambda: tuple(
        a.reshape(2, 7, 4) for a in rand_dq(14, 47)) + (rand((2, 40, 3), 49), _skin(50)),
    "compute_weights": lambda: (np.abs(rand((2, 3, 8, 1), 51)) * 5,
                                np.full((2, 3, 8, 1), 0.1, np.float32)),
    "sample_cam_rays": lambda: (
        np.concatenate([rand((2, 5, 2), 52, 20.0), np.ones((2, 5, 1), np.float32)], -1),
        np.asarray(JG.K2inv(jnp.asarray([[100.0, 100, 32, 32], [80, 80, 30, 34]]))),
        np.array([[0.5, 2.0], [0.1, 1.0]], np.float32)),
    "sample_pdf": _pdf_case,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    got, want = run_both(name, CASES[name]())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=ATOL,
                                   err_msg=name)


def test_quad_skeleton_tables_match():
    js, ts = JS.get_predefined_skeleton("quad"), TS.get_predefined_skeleton("quad")
    assert js.parents == ts.parents and js.symm_idx == ts.symm_idx
    assert js.topo_order == ts.topo_order
    np.testing.assert_array_equal(js.rest_joints, ts.rest_joints)


@pytest.mark.parametrize("seed", [0, 1])
def test_quad_fk_matches_jax(seed):
    """Rest joints -> local offsets -> FK (quat, trans and dual
    quaternion) -> bone centers with a shift, batched over 3 frames."""
    js, ts = JS.get_predefined_skeleton("quad"), TS.get_predefined_skeleton("quad")
    so3 = rand((3, ts.num_joints, 3), seed, 0.3)
    shift = rand((3,), seed + 10, 0.01)
    jlocal = JS.rest_joints_to_local(jnp.asarray(js.rest_joints), js)
    tlocal = TS.rest_joints_to_local(torch.as_tensor(ts.rest_joints), ts)
    np.testing.assert_allclose(tlocal.numpy(), np.asarray(jlocal), atol=ATOL)
    jlocal = jnp.broadcast_to(jlocal, (3,) + jlocal.shape)
    tlocal = tlocal.expand((3,) + tlocal.shape)
    jq, jt = JS.fk_quat_trans(jlocal, jnp.asarray(so3), js)
    tq, tt = TS.fk_quat_trans(tlocal, torch.as_tensor(so3), ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    jdq = JS.shift_joints_to_bones_dq(JS.fk_se3(jlocal, jnp.asarray(so3), js), js,
                                      shift=jnp.asarray(shift))
    tdq = TS.shift_joints_to_bones_dq(TS.fk_se3(tlocal, torch.as_tensor(so3), ts), ts,
                                      shift=torch.as_tensor(shift))
    for a, b in zip(tdq, jdq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_zero_pose_recovers_rest():
    skel = TS.get_predefined_skeleton("quad")
    local = TS.rest_joints_to_local(torch.as_tensor(skel.rest_joints), skel)
    q, t = TS.fk_quat_trans(local, torch.zeros(skel.num_joints, 3), skel)
    np.testing.assert_allclose(t.numpy(), skel.rest_joints, atol=1e-5)
    np.testing.assert_allclose(q[..., 0].numpy(), 1.0, atol=1e-6)


def test_render_pixel_matches_jax():
    """Integration of every channel kind: plain, frozen-weight, skipped,
    per-field density -> mask, normal renormalization, vis BCE."""
    M, N, D = 2, 5, 12
    fd = {
        "density": np.abs(rand((M, N, D, 1), 60)) * 4,
        "density_fg": np.abs(rand((M, N, D, 1), 61)),
        "rgb": rand((M, N, D, 3), 62),
        "normal": rand((M, N, D, 3), 63),
        "cyc_dist": rand((M, N, D, 1), 64),
        "vis": rand((M, N, D, 1), 65),
        "eikonal": rand((M, N, D, 1), 66),
        "delta_skin": rand((M, N, D, 1), 67),
        "gauss_density": np.abs(rand((M, N, D, 1), 68)),
    }
    deltas = np.abs(rand((M, N, D, 1), 69)) * 0.1
    want = JR.render_pixel({k: jnp.asarray(v) for k, v in fd.items()}, jnp.asarray(deltas))
    got = TR.render_pixel({k: torch.as_tensor(v) for k, v in fd.items()}, torch.as_tensor(deltas))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("num_inst,inst_mode", [(1, "id"), (3, "id"), (3, "none")])
@pytest.mark.parametrize("use_frame_id", [True, False])
def test_skinning_quad_matches_jax(num_inst, inst_mode, use_frame_id):
    """SkinningField's quadratic-form path against the JAX module with the
    same params (cases of tests/test_skinning_quad.py)."""
    import flax

    from lab4d_tpu.nnutils.embedding import FrameInfo as JFI
    from lab4d_tpu.nnutils.skinning import SkinningField as JSkin
    from lab4d_tpu_torch.bridge import params_from_flax
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo as TFI
    from lab4d_tpu_torch.nnutils.skinning import SkinningField as TSkin

    M, N, D, B = 4, 3, 5, 7
    offsets = [0, 4, 8]
    jm = JSkin(num_coords=B, frame_info=JFI(offsets, offsets, list(range(8))), num_inst=num_inst)
    tm = TSkin(B, TFI(offsets, offsets, list(range(8))), num_inst=num_inst)
    xyz = rand((M, N, D, 3), 70, 0.3)
    bones = tuple(a.reshape(M, B, 4) for a in rand_dq(M * B, 71))
    frame_id = np.arange(M) % 8 if use_frame_id else None
    inst_id = np.random.default_rng(72).integers(0, num_inst, M) if inst_mode == "id" else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.tensor(a)

    params = jm.init(jax.random.PRNGKey(1), j(xyz), tuple(map(j, bones)), j(frame_id), j(inst_id))
    tm.load_state_dict(params_from_flax(flax.core.unfreeze(params)["params"]))
    want = jm.apply(params, j(xyz), tuple(map(j, bones)), j(frame_id), j(inst_id), quad=True)
    with torch.no_grad():
        got = tm(t(xyz), tuple(map(t, bones)), t(frame_id), t(inst_id))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)
