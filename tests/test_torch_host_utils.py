"""Port parity: the host-side helpers of the fit_video path, on the CPU,
against the JAX package's (all NumPy, so all exact unless stated):
hull masks, the tracking helpers, _gen_line_set, _select_traj_queries, the
gist_rainbow table and matplotlib's float lookup, TrajVisualizer's colors,
Telemetry, the CLI builder, the background writer and the video writers.

Tolerances: exact throughout, but for apply_float_colormap (1e-6, as in
test_torch_render)."""
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import matplotlib
import numpy as np
import pytest
import torch

from gflow_tpu.pipeline import fit_video as j_fit
from gflow_tpu.pipeline import trainer as j_trainer
from gflow_tpu.utils import hull as j_hull
from gflow_tpu.utils import profiling as j_prof
from gflow_tpu.utils import tracking as j_track
from gflow_tpu.utils.cli import build_parser as j_parser
from gflow_tpu.viz.colormap import apply_float_colormap as j_cmap
from gflow_tpu.viz import mjpeg_avi as j_avi
from gflow_tpu.viz import video as j_video
from gflow_tpu.viz.traj_visualizer import TrajVisualizer as JVis
from gflow_tpu_torch.pipeline import fit_video as t_fit
from gflow_tpu_torch.pipeline import trainer as t_trainer
from gflow_tpu_torch.utils import bgwriter
from gflow_tpu_torch.utils import hull as t_hull
from gflow_tpu_torch.utils import profiling as t_prof
from gflow_tpu_torch.utils import tracking as t_track
from gflow_tpu_torch.utils.bgwriter import BackgroundWriter
from gflow_tpu_torch.utils.cli import build_parser as t_parser
from gflow_tpu_torch.viz import colormap as t_colormap
from gflow_tpu_torch.viz import mjpeg_avi, video
from gflow_tpu_torch.viz.traj_visualizer import TrajVisualizer as TVis


def blob_points(seed, n=60, W=64, H=48):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(3, 14, n) * (1 + 0.5 * np.sin(3 * ang))
    return np.c_[W / 2 + rad * np.cos(ang), H / 2 + rad * np.sin(ang)].astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_hull_mask_matches_jax(seed):
    pts = blob_points(seed)
    assert t_hull.native_loaded()
    th, jh = t_hull.FastConcaveHull2D(pts), j_hull.FastConcaveHull2D(pts)
    np.testing.assert_array_equal(th.hull, jh.hull)
    assert th.area() == jh.area()
    np.testing.assert_array_equal(th.mask(64, 48), jh.mask(64, 48))


def test_hull_without_native_library(monkeypatch):
    """Without the library: the convex hull, filled by PIL, as the JAX
    package fills it."""
    pts = blob_points(7)
    monkeypatch.setattr(t_hull, "_load_native", lambda: None)
    monkeypatch.setattr(j_hull, "_load_native", lambda: None)
    assert not t_hull.native_loaded()
    th, jh = t_hull.FastConcaveHull2D(pts), j_hull.FastConcaveHull2D(pts)
    np.testing.assert_array_equal(th.hull, jh.hull)
    mask = th.mask(64, 48)
    assert mask.sum() > 100
    np.testing.assert_array_equal(mask, jh.mask(64, 48))


def test_tracking_helpers_match_jax():
    rng = np.random.default_rng(0)
    uv = rng.uniform(0, 60, (200, 2))
    q = rng.uniform(0, 60, (30, 2))
    np.testing.assert_array_equal(t_track.find_closest_point(uv, q),
                                  j_track.find_closest_point(uv, q))
    seq = [rng.uniform(-3, 50, (12, 2)).astype(np.float32) for _ in range(5)]
    tracks = t_track.process_traj_to_tracks(seq)
    np.testing.assert_array_equal(tracks, j_track.process_traj_to_tracks(seq))
    segs = [(rng.uniform(size=(40, 48)) > 0.6).astype(np.uint8) * 255 for _ in range(5)]
    np.testing.assert_array_equal(t_track.process_occu(segs, tracks),
                                  j_track.process_occu(segs, tracks))
    occ = rng.uniform(size=(12, 5)) > 0.5
    pts = rng.uniform(size=(12, 5, 2))
    np.testing.assert_array_equal(t_track.extract_first_visible_points(pts, occ),
                                  j_track.extract_first_visible_points(pts, occ))


def test_gen_line_set_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(9, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.05, (9, 3)).astype(np.float32)
    rgb = rng.uniform(size=(9, 3)).astype(np.float32)
    for got, want in zip(t_trainer._gen_line_set(a, b, rgb), j_trainer._gen_line_set(a, b, rgb)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert t_trainer._pow2ceil(4097) == j_trainer._pow2ceil(4097) == 8192


@pytest.mark.parametrize("with_move", [True, False])
def test_select_traj_queries_matches_jax(with_move):
    rng = np.random.default_rng(2)
    H, W, n = 200, 300, 3000
    seg = np.zeros((H, W), np.uint8)
    if with_move:
        seg[60:140, 100:220] = 255
    uv = rng.uniform([0, 0], [W, H], (n + 50, 2)).astype(np.float32)
    still = ~((uv[:, 0] > 100) & (uv[:, 0] < 220) & (uv[:, 1] > 60) & (uv[:, 1] < 140))
    jt = SimpleNamespace(H=H, W=W, move_seg=seg, state=SimpleNamespace(
        last_num=n, last_uv=uv, still_mask=still))
    tt = SimpleNamespace(H=H, W=W, move_seg=seg, state=SimpleNamespace(
        last_num=torch.tensor(n), last_uv=torch.from_numpy(uv),
        still_mask=torch.from_numpy(still)))
    got, want = t_fit._select_traj_queries(tt), j_fit._select_traj_queries(jt)
    assert got[:3] == want[:3]
    if with_move:
        np.testing.assert_array_equal(got[3], want[3])
        assert len(got[3]) > 0
    else:
        assert got[3] is want[3] is None


def test_gist_rainbow_table_and_lookup_match_matplotlib():
    cmap = matplotlib.colormaps["gist_rainbow"]
    np.testing.assert_array_equal(np.asarray(t_colormap.GIST_RAINBOW),
                                  cmap(np.arange(256) / 255.0)[:, :3])
    u = np.concatenate([np.linspace(0, 1, 4097), [255 / 256, 1 / 256, 0.5, -0.1, 1.2]])
    for x in (u, u.astype(np.float32)):
        np.testing.assert_array_equal(t_colormap.colormap_lookup(x), cmap(x)[:, :3])
    np.testing.assert_array_equal(t_colormap.colormap_lookup(np.array([np.nan])), [[0, 0, 0]])
    ramp = (np.arange(23, dtype=np.float32) / 23)[:, None]
    np.testing.assert_allclose(
        t_colormap.apply_float_colormap(torch.from_numpy(ramp), "gist_rainbow").numpy(),
        np.asarray(j_cmap(ramp, colormap="gist_rainbow")), atol=1e-6)
    with pytest.raises(ValueError):  # every matplotlib name is baked; others raise
        t_colormap.apply_float_colormap(torch.from_numpy(ramp), "no_such_map")


@pytest.mark.parametrize("still_length", [None, 4, 0])
def test_traj_visualizer_colors_match_jax(still_length):
    tracks = np.zeros((3, 6, 2), np.float32)
    tracks[:, :, 0] = np.linspace(5, 25, 6)[None]
    tracks[:, :4, 1] = np.asarray([0, 10, 20, 30])[None]
    tracks[:, 4:, 1] = np.asarray([14.0, 16.0])[None]
    np.testing.assert_array_equal(TVis()._colors(tracks, still_length=still_length),
                                  JVis()._colors(tracks, still_length=still_length))


@pytest.mark.parametrize("pad", [0, 3])
def test_traj_visualizer_draws_as_jax(tmp_path, pad):
    """The same PIL drawing: discs at visible points, crosses at occluded
    ones, fading lines along the history; frames equal to the JAX
    package's, written through the video writers."""
    T, Q = 3, 2
    tracks = np.zeros((1, T, Q, 2), np.float32)
    tracks[0, :, :, 0] = [[10, 40], [14.3, 40], [18.6, 40]]
    tracks[0, :, :, 1] = [[10, 20], [10.5, 20], [11, 20]]
    occ = np.zeros((1, T, Q), bool)
    occ[0, -1, 1] = True
    vid = np.random.default_rng(pad).integers(0, 256, (1, T, 3, 32, 48)).astype(np.uint8)
    kw = dict(fps=2, linewidth=2, pad_value=pad)
    got = TVis(save_dir=str(tmp_path / "t"), **kw).visualize(
        video=vid, tracks=tracks, occulasions=occ, filename="vis")
    want = JVis(save_dir=str(tmp_path / "j"), **kw).visualize(
        video=vid, tracks=tracks, occulasions=occ, filename="vis")
    assert len(got) == len(want) == T + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[-1] != got[0]).any()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_telemetry_matches_jax_summary_layout(tmp_path):
    tels = []
    for prof in (t_prof, j_prof):
        tel = prof.Telemetry()
        for name in ("a", "b", "a"):
            with tel.phase(name):
                pass
        tel.count_frame(10)
        tel.gauge("k", [1])
        tels.append(tel.summary())
    got, want = tels
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 1 and got["k"] == want["k"]
    # the port drops the JAX compile's first/max/steady split and adds each
    # phase's self time and parent
    port_only, jax_only = {"self_sec", "parent"}, {"first_sec", "max_sec", "steady_sec_per_call"}
    for k in ("a", "b"):
        assert set(got["phases"][k]) == (set(want["phases"][k]) - jax_only) | port_only
        assert got["phases"][k]["calls"] == want["phases"][k]["calls"]
    with t_prof.trace(str(tmp_path / "tr")):
        torch.ones(3).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_cli_builder_matches_jax():
    def f(a: int = 1, b: float = 0.5, c: str = "x", flag: bool = False, maybe: int = None):
        return a, b, c, flag, maybe

    argv = ["--a", "3", "--b", "1.5", "--c", "y", "--flag", "--maybe", "7"]
    assert vars(t_parser(f).parse_args(argv)) == vars(j_parser(f).parse_args(argv))
    assert vars(t_parser(f).parse_args(["--no-flag"])) == vars(
        j_parser(f).parse_args(["--no-flag"]))
    assert set(vars(t_parser(t_fit.main).parse_args([]))) == set(
        vars(j_parser(j_fit.main).parse_args([]))) | {"device"}


def test_background_writer_orders_and_raises():
    w = BackgroundWriter()
    seen = []
    for i in range(5):
        w.submit(seen.append, i)
    w.flush()
    assert seen == [0, 1, 2, 3, 4]

    def boom():
        raise RuntimeError("disk on fire")

    w.submit(boom)
    w.submit(seen.append, 5)
    with pytest.raises(RuntimeError, match="disk on fire"):
        w.flush()
    assert seen[-1] == 5
    w.flush()


def flush_within(w, seconds=60):
    """w.flush() with a time limit: a lane that stopped fails the test
    rather than hanging it."""
    box = {}

    def run():
        try:
            w.flush()
        except Exception as e:
            box["err"] = e
        box["done"] = True

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert box.get("done"), "the writer did not drain"
    if "err" in box:
        raise box["err"]


def test_background_writer_keeps_each_keys_order(tmp_path):
    """200 keyed jobs over 7 files, of uneven lengths, with a short switch
    interval: each key's jobs run in submission order, and each file holds
    its last write."""
    w = BackgroundWriter()
    rng = np.random.default_rng(0)
    keys = [str(tmp_path / f"k{i}.txt") for i in range(7)]
    ran = {k: [] for k in keys}
    last = {}

    def job(path, i, sleep):
        time.sleep(sleep)
        ran[path].append(i)
        with open(path, "w") as f:
            f.write(str(i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i in range(200):
            path = keys[rng.integers(len(keys))]
            last[path] = i
            w.submit_keyed(path, job, path, i, float(rng.uniform(0, 1e-3)))
        flush_within(w)
    finally:
        sys.setswitchinterval(interval)
    assert sum(map(len, ran.values())) == 200 and w.backlog == 0
    for path, got in ran.items():
        assert got == sorted(got), path
        assert Path(path).read_text() == str(last[path])


def test_background_writer_runs_keys_side_by_side():
    """Two keyed jobs of different keys, each blocked on an event, have both
    started before either is let go: they run on two lanes at once."""
    if bgwriter.lane_count() < 2:
        pytest.skip("one usable CPU: the writer runs one lane")
    w = BackgroundWriter()
    started = [threading.Event(), threading.Event()]
    release = threading.Event()

    def job(i):
        started[i].set()
        assert release.wait(10)

    w.submit_keyed("a.png", job, 0)
    w.submit_keyed("b.png", job, 1)
    try:
        assert started[0].wait(10) and started[1].wait(10)
        assert w.backlog == 2
    finally:
        release.set()
    flush_within(w)
    assert w.backlog == 0


def test_background_writer_raises_an_error_from_any_lane():
    """A job that raises on any lane is re-raised by the next flush(), once,
    and every lane keeps working after it."""
    w = BackgroundWriter()
    lanes = bgwriter.lane_count()
    for bad in range(lanes):
        seen = []

        def boom():
            raise RuntimeError(f"lane {bad}")

        # new keys are dealt round-robin and each round deals 3 x lanes of
        # them, so key j of a round goes to lane j
        for j in range(lanes):
            if j == bad:
                w.submit_keyed(f"{bad}-{j}", boom)
            else:
                w.submit_keyed(f"{bad}-{j}", seen.append, j)
        with pytest.raises(RuntimeError, match=f"lane {bad}"):
            flush_within(w)
        flush_within(w)  # raised once
        for j in range(2 * lanes):
            w.submit_keyed(f"after-{bad}-{j}", seen.append, lanes + j)
        flush_within(w)
        assert sorted(seen) == [j for j in range(3 * lanes) if j != bad]


@pytest.mark.parametrize("W", [48, 47])
def test_mjpeg_avi_matches_jax(tmp_path, W):
    rng = np.random.default_rng(W)
    frames = [rng.integers(0, 256, (9, W, 3), dtype=np.uint8) for _ in range(3)]
    mjpeg_avi.write_mjpeg_avi(tmp_path / "t.avi", frames, 5)
    j_avi.write_mjpeg_avi(tmp_path / "j.avi", frames, 5)
    data = (tmp_path / "t.avi").read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert data == (tmp_path / "j.avi").read_bytes()


@pytest.mark.parametrize("mp4", [True, False])
def test_save_video_formats(tmp_path, monkeypatch, mp4):
    """The JAX package's choice: mp4 where imageio has an encoder, else an
    MJPEG .avi of the same basename."""
    if not mp4:
        monkeypatch.setattr(video, "_mp4_available", lambda: False)
        monkeypatch.setattr(j_video, "_mp4_available", lambda: False)
    frames = [np.full((16, 24, 3), 40 * i, np.uint8) for i in range(3)]
    got = video.save_video(tmp_path / "t.mp4", frames, 5)
    want = j_video.save_video(tmp_path / "j.mp4", frames, 5)
    assert got[-4:] == want[-4:]
    if not mp4:
        assert got.endswith(".avi")
        assert open(got, "rb").read() == open(want, "rb").read()
    assert video.save_video(tmp_path / "e.mp4", [], 5) is None
