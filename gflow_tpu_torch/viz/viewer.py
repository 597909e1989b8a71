"""Interactive scene viewer — capability parity with the reference's viser
web viewer (gflow/viewer.py:84-246: loads every per-frame checkpoint, lets a
browser orbit the camera, steps frames, shows fps / #Gaussians, renders
server-side and pushes JPEGs).

Counterpart of ``gflow_tpu/viz/viewer.py``. viser is not a dependency, so
this is a self-contained stdlib HTTP server: the embedded page sends
camera state and the server renders through the standard rasterizer
(``ops.render.render_jit`` at ``DEFAULT_CONFIG``, on ``cuda`` unless the
caller passes ``device="cpu"``; on the card a CUDA graph per capacity) and
streams JPEGs. Same surface:
`python -m gflow_tpu_torch.cli.viewer --folder <logdir> --port 8080`.

Every checkpoint's activated Gaussians stay on the device. The server's
handler threads render under one lock, which serializes the device work
(graph captures included),
and under ``torch.no_grad()``, which is per thread in PyTorch (a thread
that did not set it would build an autograd graph on every request). The
orbit mode centres on each frame's own live points.

Camera modes, matching the reference's two behaviors:
  - follow=1: the training view for the current frame (viewer.py:204-207
    resets the viser client onto the stored per-frame pose).
  - free 6-DoF: the client maintains a full c2w quaternion (wxyz) + position
    — exactly the state a viser client camera carries — and the server
    inverts it to w2c (viewer.py:76-82 quan_pos_to_extr). Mouse drag =
    yaw/pitch, WASD/RF = truck, QE = roll, wheel = dolly. The legacy orbit
    parameters (az/el/radius) remain accepted when no quaternion is sent.
"""
from __future__ import annotations

import glob
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import resolve_device

_PAGE = """<!DOCTYPE html>
<html><head><title>gflow-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px;
       border-radius:6px; }
#img { display:block; width:100vw; height:100vh; object-fit:contain; }
button { margin:2px; }
</style></head><body>
<img id="img"/>
<div id="hud">
  <div>frame <span id="fr">0</span>/<span id="total">?</span>
       | <span id="npts">?</span> pts | <span id="fps">0</span> fps</div>
  <div>drag: look &nbsp; WASD/RF: truck &nbsp; QE: roll &nbsp; wheel: dolly</div>
  <button onclick="step(-1)">prev</button>
  <button onclick="step(1)">next</button>
  <button onclick="playing=!playing">play/pause</button>
  <button onclick="resetCam()">reset view</button>
  <label><input type="checkbox" id="follow" checked> training view</label>
</div>
<script>
// free camera = full c2w quaternion (wxyz) + position, like a viser client
let cam={q:[1,0,0,0], p:[0,0,0]};
let frame=0, total=1, playing=false, drag=null, poses=[[ [1,0,0,0],[0,0,0] ]];
let t0=performance.now(), frames=0, keys={};
const img=document.getElementById('img');
fetch('/info').then(r=>r.json()).then(d=>{
  total=d.n_frames; document.getElementById('total').innerText=total;
  document.getElementById('npts').innerText=d.n_points;
  poses=d.poses; resetCam(); });
function qmul(a,b){return [
  a[0]*b[0]-a[1]*b[1]-a[2]*b[2]-a[3]*b[3],
  a[0]*b[1]+a[1]*b[0]+a[2]*b[3]-a[3]*b[2],
  a[0]*b[2]-a[1]*b[3]+a[2]*b[0]+a[3]*b[1],
  a[0]*b[3]+a[1]*b[2]-a[2]*b[1]+a[3]*b[0]];}
function qaxis(axis,ang){const s=Math.sin(ang/2);
  return [Math.cos(ang/2),axis[0]*s,axis[1]*s,axis[2]*s];}
function qrot(q,v){ // rotate v by q
  const u=[q[1],q[2],q[3]], s=q[0];
  const cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
  const d=u[0]*v[0]+u[1]*v[1]+u[2]*v[2];
  const c1=cross(u,v);
  return [2*d*u[0]+(s*s-(u[0]*u[0]+u[1]*u[1]+u[2]*u[2]))*v[0]+2*s*c1[0],
          2*d*u[1]+(s*s-(u[0]*u[0]+u[1]*u[1]+u[2]*u[2]))*v[1]+2*s*c1[1],
          2*d*u[2]+(s*s-(u[0]*u[0]+u[1]*u[1]+u[2]*u[2]))*v[2]+2*s*c1[2]];}
// camera-local rotation: post-multiply (axis in CAMERA frame)
function turn(axis,ang){cam.q=qmul(cam.q,qaxis(axis,ang));
  const n=Math.hypot(...cam.q); cam.q=cam.q.map(x=>x/n);}
function truck(dx,dy,dz){const d=qrot(cam.q,[dx,dy,dz]);
  cam.p=[cam.p[0]+d[0],cam.p[1]+d[1],cam.p[2]+d[2]];}
function resetCam(){const t=poses[frame%poses.length];
  cam={q:t[0].slice(),p:t[1].slice()};}
function free(){document.getElementById('follow').checked=false;}
function step(d){frame=(frame+d+total)%total;}
document.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];});
document.addEventListener('mouseup',()=>{drag=null;});
document.addEventListener('mousemove',e=>{
  if(drag){free();
    turn([0,1,0],-(e.clientX-drag[0])*0.004);  // yaw
    turn([1,0,0],-(e.clientY-drag[1])*0.004);  // pitch
    drag=[e.clientX,e.clientY];}});
document.addEventListener('wheel',e=>{free();truck(0,0,e.deltaY*0.002);});
document.addEventListener('keydown',e=>{keys[e.key.toLowerCase()]=true;});
document.addEventListener('keyup',e=>{keys[e.key.toLowerCase()]=false;});
setInterval(()=>{const s=0.03;
  if(keys['w']){free();truck(0,0,s);} if(keys['s']){free();truck(0,0,-s);}
  if(keys['a']){free();truck(-s,0,0);} if(keys['d']){free();truck(s,0,0);}
  if(keys['r']){free();truck(0,-s,0);} if(keys['f']){free();truck(0,s,0);}
  if(keys['q']){free();turn([0,0,1],0.03);}
  if(keys['e']){free();turn([0,0,1],-0.03);}},16);
async function loop(){
  while(true){
    if(playing){frame=(frame+1)%total;}
    const follow=document.getElementById('follow').checked?1:0;
    if(follow){resetCam();}
    const q=cam.q,p=cam.p;
    const url=`/render?frame=${frame}&follow=${follow}`+
      `&qw=${q[0]}&qx=${q[1]}&qy=${q[2]}&qz=${q[3]}`+
      `&px=${p[0]}&py=${p[1]}&pz=${p[2]}&t=${Date.now()}`;
    await new Promise(res=>{const im=new Image();
      im.onload=()=>{img.src=im.src;res();}; im.onerror=res; im.src=url;});
    document.getElementById('fr').innerText=frame;
    frames++; const now=performance.now();
    if(now-t0>1000){document.getElementById('fps').innerText=
      (frames*1000/(now-t0)).toFixed(1); t0=now; frames=0;}
  }
}
loop();
</script></body></html>"""


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def pose_to_w2c(quat_wxyz, pos) -> np.ndarray:
    """Client camera (c2w quaternion + position) -> (3, 4) w2c extrinsics —
    the reference's quan_pos_to_extr (gflow/viewer.py:76-82)."""
    c2w = np.eye(4)
    c2w[:3, :3] = _quat_to_rotmat(np.asarray(quat_wxyz, np.float64))
    c2w[:3, 3] = np.asarray(pos, np.float64)
    return np.linalg.inv(c2w)[:3].astype(np.float32)


def w2c_to_pose(extr: np.ndarray):
    """(3, 4) w2c -> (c2w quat wxyz, position) — extr_to_quan_pos
    (gflow/viewer.py:66-74), wxyz ordering as the viser client uses."""
    c2w = np.linalg.inv(np.concatenate([extr, [[0, 0, 0, 1]]], 0))
    return _rotmat_to_quat(c2w[:3, :3]), c2w[:3, 3]


class ViewerState:
    def __init__(self, folder: str, max_frames: int | None = None, device=None):
        from ..pipeline.trainer import GFlowTrainer

        ckpts = sorted(glob.glob(os.path.join(folder, "ckpt", "*.npz")))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {folder}/ckpt")
        if max_frames:
            ckpts = ckpts[:max_frames]

        self.device = resolve_device(device)
        d0 = np.load(ckpts[0])
        H, W = int(d0["height"]), int(d0["width"])
        self.H, self.W = H, W
        dummy = np.zeros((H, W, 3), np.float32)
        self.frames = []
        trainer = GFlowTrainer(gt_image=dummy, num_points=1000, make_logs=False,
                               device=self.device)
        self.trainer = trainer
        for cp in ckpts:
            trainer.load_checkpoint(cp)
            xyz, scale, rotate, opacity, rgb = trainer._activated()
            self.frames.append(
                dict(
                    xyz=xyz, scale=scale, rotate=rotate, opacity=opacity,
                    rgb=rgb, intr=trainer.intr,
                    extr=trainer.get_extr().cpu().numpy(),
                    n=trainer.current_pts_num(),
                )
            )
        self.n_points = trainer.current_pts_num()
        self.lock = threading.Lock()

    def view_extr(self, frame: int, az: float, el: float, radius: float,
                  follow: bool, pose=None) -> np.ndarray:
        """The (3, 4) w2c of a request: the frame's training camera
        (follow), the free client camera (pose), or an orbit of the
        training camera around the frame's centroid (az, el, radius)."""
        f = self.frames[frame % len(self.frames)]
        extr = f["extr"]
        if not follow and pose is not None:
            # free 6-DoF client camera: full c2w quat (wxyz) + position,
            # inverted to w2c exactly like the reference consumes the viser
            # client camera (gflow/viewer.py:76-82, 204-207)
            extr = pose_to_w2c(pose[:4], pose[4:])
        elif not follow:
            # orbit the training camera around the scene centroid
            c2w = np.linalg.inv(np.concatenate([extr, [[0, 0, 0, 1]]], 0))
            xyz = f["xyz"][: f["n"]].cpu().numpy()
            center = xyz.mean(axis=0)
            cam_pos = c2w[:3, 3]
            offset = cam_pos - center
            r0 = np.linalg.norm(offset) * (1.0 + radius)

            def rot_y(a):
                return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                 [-np.sin(a), 0, np.cos(a)]])

            def rot_x(a):
                return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                                 [0, np.sin(a), np.cos(a)]])

            new_pos = center + rot_y(az) @ rot_x(el) @ (
                offset / max(np.linalg.norm(offset), 1e-6)
            ) * r0
            fwd = center - new_pos
            fwd /= max(np.linalg.norm(fwd), 1e-9)
            up = np.asarray([0.0, -1.0, 0.0])
            right = np.cross(fwd, up)
            right /= max(np.linalg.norm(right), 1e-9)
            up2 = np.cross(fwd, right)
            R_c2w = np.stack([right, up2, fwd], axis=1)
            c2w_new = np.eye(4)
            c2w_new[:3, :3] = R_c2w
            c2w_new[:3, 3] = new_pos
            extr = np.linalg.inv(c2w_new)[:3]
        return np.asarray(extr, np.float32)

    @torch.no_grad()
    def render_rgb(self, frame: int, az: float, el: float, radius: float,
                   follow: bool, pose=None) -> torch.Tensor:
        """The request's (H, W, 3) float image on the device: ``render_jit``,
        one CUDA graph per capacity on the card, the frame's tensors and the
        camera copied into its buffers."""
        from ..ops.render import DEFAULT_CONFIG, render_jit

        f = self.frames[frame % len(self.frames)]
        extr = self.view_extr(frame, az, el, radius, follow, pose)
        return render_jit(f["xyz"], f["scale"], f["rotate"], f["opacity"], f["rgb"],
                          f["intr"], extr, 0.0, self.W, self.H, ("rgb",), DEFAULT_CONFIG,
                          device=self.device)["rgb"]

    @torch.no_grad()
    def render(self, frame: int, az: float, el: float, radius: float,
               follow: bool, pose=None) -> bytes:
        """The request's view as JPEG bytes (quality 85)."""
        from PIL import Image

        from ..ops.render import render2img

        with self.lock:
            img = render2img(self.render_rgb(frame, az, el, radius, follow, pose))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=85)
        return buf.getvalue()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
            elif u.path == "/info":
                poses = []
                for f in state.frames:
                    q, p = w2c_to_pose(f["extr"])
                    poses.append([q.tolist(), p.tolist()])
                body = json.dumps(
                    {"n_frames": len(state.frames),
                     "n_points": state.n_points,
                     "width": state.W, "height": state.H,
                     "poses": poses}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            elif u.path == "/render":
                q = parse_qs(u.query)
                g = lambda k, d: float(q.get(k, [d])[0])
                pose = None
                if "qw" in q:
                    pose = [g(k, 0) for k in
                            ("qw", "qx", "qy", "qz", "px", "py", "pz")]
                jpeg = state.render(
                    int(g("frame", 0)), g("az", 0), g("el", 0), g("r", 0),
                    bool(int(g("follow", 1))), pose=pose,
                )
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.end_headers()
                self.wfile.write(jpeg)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(folder: str, port: int = 8080, max_frames: int = None, device: str | None = None):
    state = ViewerState(folder, max_frames, device)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"[viewer] {len(state.frames)} frames, {state.n_points} points — "
          f"http://localhost:{port}")
    server.serve_forever()
