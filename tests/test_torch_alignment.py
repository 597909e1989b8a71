"""Port parity: the global alignment (gflow_tpu_torch.models.mast3r.alignment)
against the JAX package's on the CPU, on tests/test_mast3r.py's seeded
rigid-scene pointmaps (4 frames, logwin-2 symmetric graph, noisy views).
The host NumPy parts draw from the same np.random.default_rng(seed), so
the refinement starts from equal inputs; it then runs as JAX's jitted
optax loop in one package and as an eager torch loop with a hand-written
Adam in the other.

Tolerances: after 5 + 3 steps, poses and depths 1e-6 (float32 rounding of
the same arithmetic; measured 3e-8); after the full 500 + 200 steps, poses
2e-4 and depths 1e-4 relative (measured 2.4e-5 and 1.9e-6: float32
rounding accumulates over 700 Adam steps), the final loss 1e-3 relative;
the focal equal (NumPy on the same canonical maps)."""
import numpy as np
import pytest

from gflow_tpu.models.mast3r import alignment as jalign
from gflow_tpu_torch.models.mast3r import alignment
from tests.test_mast3r import _edge_preds_from_scene, _make_scene_pointmaps
from tests.test_torch_gmflow import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def scene():
    canon, poses, hw = _make_scene_pointmaps(n_frames=4)
    return _edge_preds_from_scene(canon, poses, noise=0.01, seed=1), len(poses), hw


def run_both(scene, **kw):
    preds, n, hw = scene
    return (alignment.global_align(preds, n, hw, device="cpu", **kw),
            jalign.global_align(preds, n, hw, **kw))


def test_pairs_and_focal_equal():
    for n, win, sym in ((6, 3, True), (9, 2, False), (1, 3, True)):
        assert alignment.make_pairs_logwin(n, win, sym) == jalign.make_pairs_logwin(n, win, sym)
    canon, _, (H, W) = _make_scene_pointmaps()
    for f in canon:
        assert alignment.estimate_focal(f, (W / 2, H / 2)) == jalign.estimate_focal(f, (W / 2, H / 2))
    assert alignment.cosine_decay(0.07, 500, 0) == pytest.approx(0.07)
    assert alignment.cosine_decay(0.07, 500, 250) == pytest.approx(0.035)
    assert alignment.cosine_decay(0.07, 500, 600) == 0.0


def assert_close(got, want, pose_tol, depth_tol):
    np.testing.assert_allclose(got["poses_c2w"], want["poses_c2w"], atol=pose_tol)
    np.testing.assert_allclose(got["depths"], want["depths"], rtol=depth_tol)
    assert got["focal"] == want["focal"] and got["pp"] == want["pp"]


def test_few_steps_match_tightly(scene):
    got, want = run_both(scene, n_sample=256, steps1=5, steps2=3)
    assert_close(got, want, 1e-6, 1e-6)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)
    moved = np.abs(got["poses_c2w"] - run_both(scene, n_sample=256, steps1=0, steps2=0)[0]
                   ["poses_c2w"]).max()
    assert moved > 1e-4  # the steps did move the poses


def test_full_schedule_matches(scene):
    got, want = run_both(scene, n_sample=256)
    assert_close(got, want, 2e-4, 1e-4)
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-3)
    assert got["final_loss"] < 0.01


def test_timings_are_collected(scene):
    preds, n, hw = scene
    res = alignment.global_align(preds, n, hw, n_sample=64, steps1=4, steps2=2, device="cpu",
                                 collect_timings=True)
    t = res["timings"]
    assert len(t["refine_stage_secs"]) == 2 and t["ms_per_step"] > 0
    assert t["host_assembly_sec"] >= 0
