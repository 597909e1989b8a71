"""Port parity: GFlowTrainer (gflow_tpu_torch.pipeline.trainer vs
gflow_tpu.pipeline.trainer), on the CPU, on the same two frames of
tests/synth.make_sequence at 48x32: frame 0 fitted on the lean path, then
frame 1's camera-only stage and full stage; densify off, no videos, no
trajectories. Both trainers start from the same seed, so the NumPy init
gives both the same points. Two changes to the inputs keep the comparison
meaningful, both given to both packages alike:
- the synthetic depth maps are constant per surface, so every point would
  sort on a tied key, and the two sorts order ties differently (ROADMAP,
  Queue 3): the depth maps get a uniform [0, 2e-3) ripple;
- the init's 1e-3 scales sit far below the 0.3 px^2 dilation, where the
  rotation gradients are float32 noise that Adam turns into lr-sized
  steps: the scales are set to 0.02-0.06 after the init.

Tolerances and why:
- checkpoint parameters as test_torch_train.assert_params_close holds a
  stage (every entry within 3 * sum(iterations * lr) over the stages, 99%
  within 1e-4 + 1e-4 |ref|): Adam turns tiny gradient differences into
  steps of up to ~lr where |g| ~ 0;
- still_mask agreement >= 0.99 (a point on a mask edge may flip), extr
  within 1e-4, move_seg IoU >= 0.9, the rest of the npz exact;
- a checkpoint loaded into each package renders the same view to 2e-3
  (the two compositors sum in another order)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflow_tpu.core import io as jio
from gflow_tpu.ops.render import RenderConfig as JConfig
from gflow_tpu.pipeline.trainer import GFlowTrainer as JTrainer
from gflow_tpu_torch.ops.render import RenderConfig as TConfig
from gflow_tpu_torch.pipeline.trainer import GFlowTrainer as TTrainer
from tests.synth import make_sequence

W, H = 48, 32
N_POINTS = 400  # capacity 1024; a shell trainer of capacity 256 grows to 512
RC = dict(max_per_tile=96, max_tiles_per_gaussian=16)  # tiles overflow K: t_final > 0
LOSS = dict(lambda_rgb=1.0, lambda_depth=0.1, lambda_var=50.0, lambda_flow=0.01)
STAGES = (  # (name, iterations, lr): frame 0, camera-only stage, full stage
    ("00000", 20, 1e-2), ("00001", 8, 1e-4), ("00001", 10, 5e-3))


def fit(cls, cfg_cls, seq, files, logs, **kw):
    img0 = jio.load_image(files["images"][0])
    d0 = jio.read_depth(files["depths"][0])
    focal, pp, extrs = jio.read_camera(files["cameras"])
    tr = cls(gt_image=img0, gt_depth=d0, num_points=N_POINTS, logs_suffix=str(logs),
             render_config=cfg_cls(**RC), seed=3, **kw)
    tr.k_escalate_threshold = 0.0
    tr.load_camera(focal=focal, pp=pp)
    tr.load_camera(extr=extrs[0])
    tr.init_gaussians_from_image(img0, d0)
    scale = np.array(tr.params.scale)
    scale[:N_POINTS] = np.random.default_rng(9).uniform(0.02, 0.06, (N_POINTS, 3))
    tr.params = tr.params._replace(scale=torch.from_numpy(scale) if cls is TTrainer
                                   else jnp.asarray(scale))
    move = [jio.read_mask(p) for p in files["move_masks"]]
    tr.train(iterations=20, lr=1e-2, lr_camera=0.0, save_imgs=True, save_ckpt=True,
             ckpt_name="00000", lambda_still=0.0, move_mask=move[0], **LOSS)
    tr.set_gt_image(jio.load_image(files["images"][1]))
    tr.set_gt_depth(jio.read_depth(files["depths"][1]))
    tr.set_gt_flow(jio.read_flow(files["flows"][0]))
    tr.load_camera(extr=extrs[1])
    tr.train(iterations=8, lr_camera=1e-4, save_imgs=True, save_ckpt=True, ckpt_name="00001",
             camera_only=True, move_mask=move[1], **LOSS)
    tr.train(iterations=10, lr=5e-3, lr_camera=0.0, save_imgs=True, save_ckpt=True,
             ckpt_name="00001", lambda_still=1.0, move_mask=move[1], **LOSS)
    tr.flush_io()
    return tr


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    seq = make_sequence(root, n_frames=3, W=W, H=H)
    files = jio.list_sequence_files(seq)
    for i, path in enumerate(files["depths"]):
        d = np.load(path)
        np.save(path, d + np.random.default_rng(i).uniform(0, 2e-3, d.shape).astype(np.float32))
    jt = fit(JTrainer, JConfig, seq, files, root / "jax_logs")
    tt = fit(TTrainer, TConfig, seq, files, root / "torch_logs", device="cpu")
    return jt, tt, root


def ckpt(tr, name):
    return dict(np.load(os.path.join(tr.dir, "ckpt", f"{name}.npz")))


@pytest.mark.parametrize("name", ["00000", "00001"])
def test_checkpoints_match_jax(fits, name):
    jt, tt, _ = fits
    cj, ct = ckpt(jt, name), ckpt(tt, name)
    assert set(ct) == set(cj)
    for k in cj:
        assert ct[k].dtype == cj[k].dtype and ct[k].shape == cj[k].shape, k
    iters = STAGES[:1] if name == "00000" else STAGES
    bound = 3 * sum(i * lr for _, i, lr in iters)
    for k in ("xyz", "scale", "rotate", "opacity", "rgb"):
        with np.errstate(invalid="ignore"):  # equal infinities (an init color of 0 or 1)
            diff = np.where(ct[k] == cj[k], 0.0, np.abs(ct[k] - cj[k]))
        assert diff.max() <= bound, (k, diff.max())
        bulk = diff <= 1e-4 + 1e-4 * np.abs(cj[k])
        assert bulk.mean() >= 0.99, (k, bulk.mean())
    assert (ct["still_mask"] == cj["still_mask"]).mean() >= 0.99
    np.testing.assert_allclose(ct["extr"], cj["extr"], atol=1e-4)
    for k in ("intr", "width", "height"):
        np.testing.assert_array_equal(ct[k], cj[k], err_msg=k)
    np.testing.assert_allclose(ct["last_uv"], cj["last_uv"], atol=0.1)
    mt, mj = ct["move_seg"] > 0, cj["move_seg"] > 0
    assert mj.any(), "no move segmentation: the test would be vacuous"
    assert (mt & mj).sum() / (mt | mj).sum() >= 0.9


def test_stage_outputs_match_jax(fits):
    """The same files in both log directories, and the trainers' host
    state: segmentation, escalations, the mirror of last_num."""
    jt, tt, _ = fits
    for sub in ("images", "images_seg", "ckpt"):
        assert sorted(os.listdir(os.path.join(tt.dir, sub))) == sorted(
            os.listdir(os.path.join(jt.dir, sub))), sub
    assert tt._last_num_host == jt._last_num_host == int(tt.state.last_num)
    assert tt.current_pts_num() == jt.current_pts_num()


def test_k_escalation_matches_jax(fits):
    """With k_escalate_threshold 0 both escalate to 192 after the same
    stage (frame 0's, the pre-seed) and no more."""
    jt, tt, _ = fits
    ej, et = jt.k_escalations, tt.k_escalations
    assert [(e["ckpt"], e["to_k"], e["preseed"]) for e in et] == \
        [(e["ckpt"], e["to_k"], e["preseed"]) for e in ej] == [("00000", 192, True)]
    assert tt.render_config.max_per_tile == jt.render_config.max_per_tile == 192
    assert et[0]["t_final_mean"] == pytest.approx(ej[0]["t_final_mean"], rel=1e-2, abs=1e-4)


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_checkpoints_load_across_packages(fits, src):
    """Each package's npz into a shell trainer of both packages (capacity
    256: both grow to 512), then the same view rendered by both."""
    jt, tt, _ = fits
    path = os.path.join((jt if src == "jax" else tt).dir, "ckpt", "00001.npz")
    img = np.zeros((H, W, 3), np.float32)
    js = JTrainer(gt_image=img, num_points=100, capacity=256, make_logs=False)
    ts = TTrainer(gt_image=img, num_points=100, capacity=256, make_logs=False, device="cpu")
    js.load_checkpoint(path)
    ts.load_checkpoint(path)
    assert js.capacity == ts.capacity == 512
    n = len(np.load(path)["xyz"])
    assert js.current_pts_num() == ts.current_pts_num() == n
    for f in ("xyz", "scale", "rotate", "opacity", "rgb"):
        np.testing.assert_array_equal(getattr(ts.params, f).numpy(),
                                      np.asarray(getattr(js.params, f)), err_msg=f)
    for f in ("still_mask", "still_mask_tentative", "last_uv", "last_depth", "last_xyz"):
        assert getattr(ts.state, f).shape[0] == 512, f
    np.testing.assert_array_equal(ts.intr.numpy(), np.asarray(js.intr))
    np.testing.assert_allclose(ts.get_extr().numpy(), np.asarray(js.get_extr()), atol=1e-6)
    want = np.asarray(js.render_views(("rgb", "depth_map"))["rgb"])
    got = ts.render_views(("rgb", "depth_map"))["rgb"].numpy()
    assert want.std() > 0.05  # the fitted scene, not a background fill
    np.testing.assert_allclose(got, want, atol=2e-3)
    uv_t, d_t = ts.project_points(np.asarray(js.params.xyz[:50]))
    uv_j, d_j = js.project_points(np.asarray(js.params.xyz[:50]))
    np.testing.assert_allclose(uv_t, np.asarray(uv_j), atol=1e-3)


def test_set_gt_uploads_each_call(fits):
    """A target map is uploaded at every set_gt_* call, so a buffer
    mutated in place and set again is what the next stage sees."""
    _, tt, _ = fits
    buf = np.full((H, W, 3), 0.25, np.float32)
    tt.set_gt_image(buf)
    buf[:] = 0.75
    tt.set_gt_image(buf)
    assert float(tt._targets().image.mean()) == pytest.approx(0.75)
    assert torch.equal(tt._targets().depth[..., 0], torch.from_numpy(tt.gt_depth))


def test_traj_capacity_fixed_at_first_append(fits):
    """The trajectory line set's capacity is set at the first append and
    kept: later appends past it drop the oldest entries (the JAX package
    raises its capacity on every eval instead; ROADMAP, Queue 3)."""
    _, tt, _ = fits
    idx = list(range(0, N_POINTS, 25))  # 16 queries
    tt._traj = None
    xyz0 = tt.params.xyz.clone()
    caps, lens = [], []
    for k in range(7):  # every step moves the queries by 0.5: 49 line points each
        tt.params = tt.params._replace(xyz=xyz0 + torch.tensor([0.5 * (k % 2), 0.0, 0.0]))
        img, center, depth, traj, upon = tt.eval(idx, line_scale=0.5, point_scale=2.0,
                                                 alpha=0.8)
        caps.append(tt._traj_cap)
        lens.append(len(tt._traj["xyz"]))
        assert traj.shape == upon.shape == (H, W, 3) and traj.dtype == np.uint8
    tt.params = tt.params._replace(xyz=xyz0)
    assert caps[1:] == [4096] * 6, caps  # max(4096, pow2ceil(816 + 3 * 816))
    assert lens[:2] == [16, 16 + 16 * 50] and lens[-1] == 4096, lens
