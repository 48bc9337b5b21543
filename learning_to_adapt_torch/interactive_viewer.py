"""Interactive trajectory viewer on the port (tools/interactive_viewer.py
of the JAX package, on the port's renderer).

Exports a replay .npz (from `python -m learning_to_adapt_torch.sim_policy`)
as ONE self-contained HTML file: a canvas animation of the articulated body
with play/pause, scrubbing, speed control, wheel zoom, drag pan, a
follow-the-torso tracking camera and a reward sparkline synced to the
playhead. No server, no dependencies: open the file in any browser.

    python -m learning_to_adapt_torch.sim_policy data/grbal_torch/<exp>
    python -m learning_to_adapt_torch.interactive_viewer \
        data/grbal_torch/<exp>/replay.npz --env half_cheetah [--device cpu]

Forward kinematics runs on the card unless --device cpu is given; without
a card it raises. The page template is this module's own copy of the JAX
tool's.
"""
import argparse
import json
import os

import numpy as np

from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.render_trajectory import render_frames

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ltao replay — %(title)s</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 12px; background: #15171a; color: #ddd; }
 canvas { background: #1e2126; border: 1px solid #333; display: block; }
 #spark { margin-top: 4px; }
 .bar { display: flex; gap: 10px; align-items: center; margin: 8px 0; }
 input[type=range] { flex: 1; }
 button { background: #2a2e35; color: #ddd; border: 1px solid #444;
          padding: 4px 12px; cursor: pointer; }
 .hint { color: #777; font-size: 12px; }
</style></head><body>
<div>ltao interactive replay — <b>%(title)s</b>
 <span class="hint">(drag: pan &middot; wheel: zoom &middot; space: play/pause
  &middot; &larr;/&rarr;: step)</span></div>
<div class="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="seek" min="0" max="0" value="0">
 <span id="label" style="min-width:220px"></span>
 <select id="speed"><option>0.25</option><option>0.5</option>
  <option selected>1</option><option>2</option><option>4</option></select>
 <label><input type="checkbox" id="follow" checked> follow</label>
</div>
<canvas id="view" width="960" height="420"></canvas>
<canvas id="spark" width="960" height="70"></canvas>
<script>
const D = %(data)s;
const view = document.getElementById('view'), vc = view.getContext('2d');
const spark = document.getElementById('spark'), sc = spark.getContext('2d');
const seek = document.getElementById('seek');
const label = document.getElementById('label');
const playBtn = document.getElementById('play');
let t = 0, playing = false, scale = 110, panX = 0, panY = 0, last = 0;
seek.max = D.frames.length - 1;
const cum = D.cumret;  // exact cumulative return at each sampled frame
                       // (computed host-side from ALL rewards, not the
                       // stride-sampled sparkline series)
function world2px(x, z, camx) {
  return [view.width * 0.35 + (x - camx) * scale + panX,
          view.height * 0.82 - z * scale + panY];
}
function draw() {
  const f = D.frames[t];
  const camx = document.getElementById('follow').checked ? f.c : 0;
  vc.clearRect(0, 0, view.width, view.height);
  vc.strokeStyle = '#3d4450'; vc.lineWidth = 1.5;   // ground z=0
  vc.beginPath();
  let [gx0, gy] = world2px(-1e3, 0, camx); let [gx1] = world2px(1e3, 0, camx);
  vc.moveTo(gx0, gy); vc.lineTo(gx1, gy); vc.stroke();
  vc.strokeStyle = '#2c313a';                        // 1m x-grid ticks
  for (let gxm = Math.floor(camx) - 6; gxm < camx + 8; gxm++) {
    const [tx, ty] = world2px(gxm, 0, camx);
    vc.beginPath(); vc.moveTo(tx, ty); vc.lineTo(tx, ty + 6); vc.stroke();
  }
  vc.lineCap = 'round';
  for (const s of f.s) {                             // capsule/box segments
    const [x1, y1] = world2px(s[0], s[1], camx);
    const [x2, y2] = world2px(s[2], s[3], camx);
    vc.strokeStyle = '#c8863c'; vc.lineWidth = Math.max(s[4] * 2 * scale, 2);
    vc.beginPath(); vc.moveTo(x1, y1); vc.lineTo(x2, y2); vc.stroke();
  }
  for (const b of f.b) {                             // spheres
    const [x, y] = world2px(b[0], b[1], camx);
    vc.fillStyle = '#e0a050';
    vc.beginPath(); vc.arc(x, y, Math.max(b[2] * scale, 2), 0, 7); vc.fill();
  }
  label.textContent = 't=' + (t * D.stride) + '/' + D.T +
    '  x=' + f.c.toFixed(2) + 'm  R=' + cum[t].toFixed(1);
  seek.value = t;
  // reward sparkline + playhead
  sc.clearRect(0, 0, spark.width, spark.height);
  const n = D.rewards.length;
  let lo = Math.min(...D.rewards), hi = Math.max(...D.rewards);
  if (hi - lo < 1e-9) hi = lo + 1;
  sc.strokeStyle = '#6fae6f'; sc.beginPath();
  for (let i = 0; i < n; i++) {
    const x = i / (n - 1) * spark.width;
    const y = spark.height - 4 - (D.rewards[i] - lo) / (hi - lo) * (spark.height - 8);
    i ? sc.lineTo(x, y) : sc.moveTo(x, y);
  }
  sc.stroke();
  sc.strokeStyle = '#ddd';
  sc.beginPath();
  sc.moveTo(t / (n - 1) * spark.width, 0);
  sc.lineTo(t / (n - 1) * spark.width, spark.height);
  sc.stroke();
}
function tick(ts) {
  if (playing) {
    const dt = ts - last;
    const fps = 25 * parseFloat(document.getElementById('speed').value);
    if (dt > 1000 / fps) {
      t = (t + 1) %% D.frames.length; last = ts; draw();
    }
  }
  requestAnimationFrame(tick);
}
playBtn.onclick = () => { playing = !playing;
  playBtn.innerHTML = playing ? '&#10074;&#10074;' : '&#9654;'; };
seek.oninput = () => { t = +seek.value; draw(); };
view.onwheel = e => { e.preventDefault();
  scale *= e.deltaY < 0 ? 1.1 : 0.9; draw(); };
let drag = null;
view.onmousedown = e => drag = [e.clientX - panX, e.clientY - panY];
window.onmousemove = e => { if (drag) {
  panX = e.clientX - drag[0]; panY = e.clientY - drag[1]; draw(); } };
window.onmouseup = () => drag = null;
window.onkeydown = e => {
  if (e.code === 'Space') { e.preventDefault(); playBtn.onclick(); }
  if (e.code === 'ArrowRight') { t = Math.min(t + 1, D.frames.length - 1); draw(); }
  if (e.code === 'ArrowLeft') { t = Math.max(t - 1, 0); draw(); }
};
draw(); requestAnimationFrame(tick);
</script></body></html>
"""


def export_html(replay_path, env_name, rollout=0, stride=4, out=None,
                track_body='torso', device=None):
    """Writes the replay's HTML viewer (default: beside the .npz) and
    returns its path. track_body is kept for the JAX tool's signature: the
    camera follows the root's x. device None: the card."""
    model = get_model(env_name)
    data = np.load(replay_path)
    qpos_seq = np.asarray(data['qpos'][rollout])
    rewards = np.asarray(data['rewards'][rollout])
    frames = render_frames(qpos_seq, model, stride=stride, device=device)

    # serialize: per frame the x-z segment endpoints + radii, sphere
    # centers + radii, and the camera anchor (root x: the tracking camera's
    # target)
    ser = []
    for i, (segs, spheres) in enumerate(frames):
        cam = float(qpos_seq[i * stride][0])
        ser.append(dict(
            s=[[round(float(e1[0]), 4), round(float(e1[2]), 4),
                round(float(e2[0]), 4), round(float(e2[2]), 4),
                round(float(r), 4)] for e1, e2, r in segs],
            b=[[round(float(c[0]), 4), round(float(c[2]), 4),
                round(float(r), 4)] for c, r in spheres],
            c=round(cam, 4)))
    cumret = np.cumsum(rewards)
    payload = dict(frames=ser, stride=stride, T=int(len(qpos_seq)),
                   rewards=[round(float(r), 4)
                            for r in rewards[::stride][:len(ser)]],
                   cumret=[round(float(c), 2)
                           for c in cumret[::stride][:len(ser)]])
    html = _PAGE % dict(title=f'{env_name} — {os.path.basename(replay_path)}',
                        data=json.dumps(payload))
    out = out or replay_path.replace('.npz', '.html')
    with open(out, 'w') as f:
        f.write(html)
    print(f'wrote {out} ({len(ser)} frames, '
          f'{os.path.getsize(out) // 1024} KB): open in a browser')
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.interactive_viewer')
    p.add_argument('replay', type=str)
    p.add_argument('--env', type=str, default='half_cheetah')
    p.add_argument('--rollout', type=int, default=0)
    p.add_argument('--stride', type=int, default=4)
    p.add_argument('--out', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs without a card")
    args = p.parse_args(argv)
    return export_html(args.replay, args.env, rollout=args.rollout,
                       stride=args.stride, out=args.out, device=args.device)


if __name__ == '__main__':
    main()
