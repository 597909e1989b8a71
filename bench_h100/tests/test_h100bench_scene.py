"""The synthetic video: made from the seed alone, periodic, its geometry
fixed by the traffic; its files in the layout fit_video reads."""
import numpy as np
import pytest

from scene.sequence import Sequence, frame_files, write_frames, write_sequence
from tiny import TINY_SCENE

TRAFFIC = dict(TINY_SCENE, period=6, camera_shift=0.08, camera_yaw_deg=2.0, texture_octaves=3)


def test_same_seed_same_video_other_seed_same_geometry():
    a, b, c = Sequence(TRAFFIC, 2 ** 31 + 5), Sequence(TRAFFIC, 2 ** 31 + 5), Sequence(TRAFFIC, 9)
    for t in (0, 3):
        ia, da, ma, _ = a.render(t)
        ib, db, mb, _ = b.render(t)
        ic, dc, mc, _ = c.render(t)
        assert np.array_equal(ia, ib) and np.array_equal(da, db)
        assert not np.array_equal(ia, ic)              # the seed draws the textures
        assert np.array_equal(da, dc) and np.array_equal(ma, mc)  # not the geometry


def test_periodic_and_frame_zero_at_identity():
    s = Sequence(TRAFFIC, 1)
    assert np.allclose(s.pose(0), np.eye(4))
    for t in range(3):
        assert np.array_equal(s.render(t)[0], s.render(t + s.period)[0])
        assert np.allclose(s.pose(t), s.pose(t + s.period))


@pytest.mark.parametrize("t", [0, 4, 5])
def test_flow_carries_each_pixel_to_its_next_frame(t):
    """Frame period - 1's flow leads to frame period, which is frame 0: a
    pixel moved by the flow lands on its own world point in frame t + 1."""
    s = Sequence(TRAFFIC, 3)
    img, depth, inside, P = s.render(t)
    flow, occ = s.flow_and_occlusion(t, inside, P)
    P_next = P + np.where(inside[..., None], s.object_step(t), 0.0)
    uv = s.project(P_next, (t + 1) % s.period)
    H, W = depth.shape
    u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    assert np.allclose(uv - np.stack([u, v], -1), flow, atol=1e-3)
    assert 0 < inside.mean() < 0.5 and occ.dtype == bool


def test_files_in_fit_video_layout(tmp_path):
    s = Sequence(TRAFFIC, 4)
    seq = write_sequence(s, tmp_path)
    for k in (1, s.period, s.period + 1):
        for p in frame_files(seq, s.period, k).values():
            assert p and __import__("os").path.exists(p), p
    frames = write_frames(s, tmp_path / "f", 3)
    assert len(list(frames.glob("*.jpg"))) == 3

