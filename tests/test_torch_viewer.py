"""Port parity: the viewer (gflow_tpu_torch.viz.viewer vs
gflow_tpu.viz.viewer) on the CPU, on three hand-written checkpoints of
seeded Gaussians with distinct depths (tied sort keys order differently
in the two packages; ROADMAP, Queue 3) and 300, 320 and 340 live points.

Tolerances and why:
- pose_to_w2c / w2c_to_pose: NumPy copies, equal to 1e-12; the round
  trip to 1e-6 (float32 w2c);
- renders: each package's rasterizer (float32, sums in another order)
  then a JPEG at quality 85: the decoded images within 2 levels on >= 99%
  of pixels;
- /info: equal, the poses to 1e-6 (each package derives the float32 w2c
  from its own pose parameters).

The orbit mode centres on each frame's own live points, where the JAX
package takes the last checkpoint's count for every frame (ROADMAP, Queue
3), so the two are compared at the last frame, and the port's per-frame
centre is checked on its own."""
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from gflow_tpu.viz import viewer as jv
from gflow_tpu_torch.utils.cli import build_parser
from gflow_tpu_torch.viz import viewer as tv

W, H = 96, 64
COUNTS = (300, 320, 340)
FOLLOW = dict(az=0.0, el=0.0, radius=0.0, follow=True)
ORBIT = dict(az=0.4, el=-0.2, radius=0.3, follow=False)
POSE = [0.98, 0.05, -0.15, 0.1, 0.1, -0.05, -0.2]  # c2w quat (wxyz) + position


def write_checkpoints(folder):
    rng = np.random.default_rng(0)
    os.makedirs(folder / "ckpt")
    n = max(COUNTS)
    z = (1.6 + 0.8 * rng.permutation(n) / n).astype(np.float32)
    u, v = rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)
    f32 = lambda a: np.asarray(a, np.float32)
    xyz = f32(np.c_[(u - W / 2) * z / 80.0, (v - H / 2) * z / 80.0, z])
    raw = dict(scale=f32(rng.uniform(0.01, 0.04, (n, 3))), rotate=f32(rng.normal(size=(n, 4))),
               opacity=f32(rng.uniform(0.5, 3.0, (n, 1))), rgb=f32(rng.normal(0, 1.5, (n, 3))))
    for t, k in enumerate(COUNTS):
        extr = f32(np.c_[np.eye(3), [0.03 * t, 0.01 * t, 0.0]])
        np.savez(folder / "ckpt" / f"{t:05d}.npz", xyz=xyz[:k] + f32([0.02 * t, 0, 0]),
                 **{name: a[:k] for name, a in raw.items()},
                 intr=f32([80.0, 80.0, W / 2, H / 2]), extr=extr, still_mask=np.ones(k, bool),
                 last_uv=np.zeros((k, 2), np.float32), move_seg=np.zeros(0), width=W, height=H)


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    folder = tmp_path_factory.mktemp("viewer")
    write_checkpoints(folder)
    return jv.ViewerState(str(folder)), tv.ViewerState(str(folder), device="cpu"), folder


def decode(jpeg: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("seed", range(6))
def test_pose_conversions_match_jax(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    if seed < 3:  # rotations of more than 120 degrees: the trace <= 0 branch
        q[0] = 0.1 * q[0]
    q /= np.linalg.norm(q)
    pos = rng.normal(size=3)
    extr = tv.pose_to_w2c(q, pos)
    np.testing.assert_allclose(extr, jv.pose_to_w2c(q, pos), rtol=0, atol=1e-12)
    for got, want in zip(tv.w2c_to_pose(extr), jv.w2c_to_pose(extr)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    q2, p2 = tv.w2c_to_pose(extr)
    np.testing.assert_allclose(q2 * np.sign(q2[0] * q[0]), q, atol=1e-6)
    np.testing.assert_allclose(p2, pos, atol=1e-6)


# orbit at the last frame only: below it the centres differ by design
@pytest.mark.parametrize("mode,frame", [("follow", 0), ("follow", 2), ("orbit", 2),
                                        ("free", 0), ("free", 2)])
def test_renders_match_jax(states, mode, frame):
    js, ts, _ = states
    kw = {"follow": FOLLOW, "orbit": ORBIT, "free": dict(ORBIT, pose=POSE)}[mode]
    got, want = decode(ts.render(frame, **kw)), decode(js.render(frame, **kw))
    assert got.shape == want.shape == (H, W, 3)
    assert want.std() > 10  # the scene, not a background fill
    assert (np.abs(got - want) <= 2).all(axis=-1).mean() >= 0.99


def test_orbit_centres_on_the_frames_own_points(states):
    """Frame 0 orbits the same in a state of all three checkpoints and in
    one of frame 0 alone (its own 300 points either way)."""
    _, ts, folder = states
    alone = tv.ViewerState(str(folder), max_frames=1, device="cpu")
    assert alone.n_points == COUNTS[0] and ts.n_points == COUNTS[-1]
    np.testing.assert_array_equal(ts.view_extr(0, **ORBIT), alone.view_extr(0, **ORBIT))
    assert not np.allclose(ts.view_extr(0, **ORBIT), ts.view_extr(0, **FOLLOW))


def serve(state, module):
    server = ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_http_surface_matches_jax(states):
    js, ts, _ = states
    infos = {}
    for name, state, module in (("jax", js, jv), ("port", ts, tv)):
        server, thread, base = serve(state, module)
        try:
            status, ctype, body = get(base + "/info")
            assert status == 200 and ctype == "application/json"
            infos[name] = json.loads(body)
            if name == "port":
                status, ctype, page = get(base + "/")
                assert status == 200 and ctype == "text/html" and b"/render?frame=" in page
                status, ctype, jpeg = get(base + "/render?frame=1&follow=0&az=0.3&el=0&r=0")
                assert status == 200 and ctype == "image/jpeg"
                assert decode(jpeg).shape == (H, W, 3)
                with pytest.raises(urllib.error.HTTPError) as err:
                    get(base + "/nothing")
                assert err.value.code == 404
        finally:
            stop(server, thread)
    got, want = infos["port"], infos["jax"]
    assert {k: v for k, v in got.items() if k != "poses"} == {
        k: v for k, v in want.items() if k != "poses"} == {
        "n_frames": 3, "n_points": COUNTS[-1], "width": W, "height": H}
    np.testing.assert_allclose([x for q, p in got["poses"] for x in q + p],
                               [x for q, p in want["poses"] for x in q + p], atol=1e-6)


def test_concurrent_requests_render_the_same(states):
    """Eight handler threads at once (more than this machine's share of
    cores may be): every response is the JPEG one request alone gets."""
    _, ts, _ = states
    url = "/render?frame=2&follow=0&qw=0.98&qx=0.05&qy=-0.15&qz=0.1&px=0.1&py=-0.05&pz=-0.2"
    server, thread, base = serve(ts, tv)
    try:
        alone = get(base + url)[2]
        results = [None] * 8

        def fetch(i):
            results[i] = get(base + url)[2]

        workers = [threading.Thread(target=fetch, args=(i,)) for i in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
            assert not w.is_alive()
    finally:
        stop(server, thread)
    assert all(r == alone for r in results)


def test_device_rule_and_cli(states, monkeypatch):
    _, _, folder = states
    args = build_parser(tv.main).parse_args(["--folder", str(folder), "--device", "cpu"])
    assert (args.device, args.port, args.max_frames) == ("cpu", 8080, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.ViewerState(str(folder))
