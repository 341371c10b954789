"""Interactive point-cloud viewer: PLY -> self-contained HTML orbit view.

The reference renders its reconstruction in a GLFW window with a
mouse-orbit camera (/root/reference/src/main.cpp:318-352, camera
:406-445).  This environment is headless, so the interactive
equivalent is a single self-contained HTML file: the point cloud is
embedded as a base64 Float32 buffer and rendered on a 2D canvas with
an orbit/zoom/pan camera in vanilla JS (no GL, no external deps —
opens in any browser).

Controls: drag = orbit, wheel = zoom, shift-drag = pan, double-click =
reset.

Usage: python tools/view_ply.py in.ply [-o out.html] [--max-points N]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_ply(path):
    """Minimal PLY reader for the writer's own output (ascii or
    binary_little_endian, x/y/z [+ red/green/blue])."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end + len(b"end_header\n"):]
    fmt = next((l.split()[1] for l in header if l.startswith("format")), "")
    n = next(
        (int(l.split()[2]) for l in header if l.startswith("element vertex")),
        0,
    )
    props = [l.split()[1:] for l in header if l.startswith("property")]
    names = [p[1] for p in props]
    types = [p[0] for p in props]
    has_rgb = {"red", "green", "blue"} <= set(names)
    if fmt == "ascii":
        rows = body.decode("ascii", "replace").split("\n")[:n]
        vals = np.array(
            [[float(v) for v in r.split()[: len(names)]] for r in rows if r],
            np.float64,
        )
    elif fmt == "binary_little_endian":
        fmap = {"float": "f", "float32": "f", "uchar": "B", "uint8": "B",
                "double": "d", "int": "i"}
        rec = "<" + "".join(fmap[t] for t in types)
        sz = struct.calcsize(rec)
        vals = np.array(
            [struct.unpack(rec, body[i * sz:(i + 1) * sz]) for i in range(n)],
            np.float64,
        )
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")
    ix = [names.index(c) for c in ("x", "y", "z")]
    xyz = vals[:, ix].astype(np.float32)
    rgb = None
    if has_rgb:
        ic = [names.index(c) for c in ("red", "green", "blue")]
        rgb = vals[:, ic].astype(np.uint8)
    return xyz, rgb


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sfm_jax viewer</title><style>
html,body{margin:0;height:100%;background:#111;overflow:hidden}
canvas{display:block}
#hud{position:fixed;left:10px;top:8px;color:#9a9;font:12px monospace}
</style></head><body>
<div id="hud">drag orbit · wheel zoom · shift-drag pan · dblclick reset</div>
<canvas id="c"></canvas>
<script>
const PTS = Uint8Array.from(atob("@B64@"), c=>c.charCodeAt(0));
const xyz = new Float32Array(PTS.buffer, 0, @N@*3);
const rgb = @RGB@;
const N = @N@, cvs = document.getElementById('c'), ctx = cvs.getContext('2d');
let W,H; const resize=()=>{W=cvs.width=innerWidth;H=cvs.height=innerHeight;draw()};
// center/scale
let cx=0,cy=0,cz=0; for(let i=0;i<N;i++){cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2];}
cx/=N;cy/=N;cz/=N; let r=0;
for(let i=0;i<N;i++){const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,dz=xyz[3*i+2]-cz;
  r=Math.max(r,Math.hypot(dx,dy,dz));}
const R0={th:0.5,ph:0.3,d:2.8,ox:0,oy:0};
let th=R0.th,ph=R0.ph,dist=R0.d,ox=R0.ox,oy=R0.oy;
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
  const ct=Math.cos(th),st=Math.sin(th),cp=Math.cos(ph),sp=Math.sin(ph);
  const f=0.9*Math.min(W,H), zs=dist*r;
  for(let i=0;i<N;i++){
    let x=xyz[3*i]-cx, y=xyz[3*i+1]-cy, z=xyz[3*i+2]-cz;
    let X= ct*x+st*z, Z=-st*x+ct*z;
    let Y= cp*y-sp*Z, Zc=sp*y+cp*Z+zs;
    if(Zc<=r*0.05) continue;
    const s=f/Zc, px=W/2+X*s+ox, py=H/2-Y*s+oy;
    if(px<0||px>=W||py<0||py>=H) continue;
    if(rgb){ctx.fillStyle=`rgb(${rgb[3*i]},${rgb[3*i+1]},${rgb[3*i+2]})`;}
    else{const sh=Math.max(60,Math.min(255,255-(Zc-zs+r)*120/r));
         ctx.fillStyle=`rgb(${sh*0.5|0},${sh|0},${sh*0.75|0})`;}
    const ps=Math.max(1,Math.min(3,2.5*r*0.01*s));
    ctx.fillRect(px,py,ps,ps);
  }
}
let drag=null;
cvs.onmousedown=e=>drag={x:e.clientX,y:e.clientY,sh:e.shiftKey};
onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  if(drag.sh){ox+=dx;oy+=dy;}else{th+=dx*0.008;ph+=dy*0.008;
    ph=Math.max(-1.55,Math.min(1.55,ph));}
  drag.x=e.clientX;drag.y=e.clientY;draw();};
onmouseup=()=>drag=null;
cvs.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);
  dist=Math.max(0.3,Math.min(30,dist));draw();};
cvs.ondblclick=()=>{th=R0.th;ph=R0.ph;dist=R0.d;ox=R0.ox;oy=R0.oy;draw();};
onresize=resize; resize();
</script></body></html>
"""


def write_html(xyz, rgb, out_path):
    b64 = base64.b64encode(np.ascontiguousarray(xyz).tobytes()).decode()
    rgb_js = "null"
    if rgb is not None:
        rgb_js = json.dumps(rgb.reshape(-1).tolist())
    html = (_HTML.replace("@B64@", b64)
            .replace("@N@", str(len(xyz)))
            .replace("@RGB@", rgb_js))
    with open(out_path, "w") as f:
        f.write(html)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ply")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--max-points", type=int, default=200000)
    args = ap.parse_args()
    xyz, rgb = load_ply(args.ply)
    if len(xyz) > args.max_points:
        sel = np.random.default_rng(0).choice(
            len(xyz), args.max_points, replace=False
        )
        xyz = xyz[sel]
        rgb = rgb[sel] if rgb is not None else None
    out = args.out or os.path.splitext(args.ply)[0] + ".html"
    write_html(xyz, rgb, out)
    print(f"wrote {out}: {len(xyz)} points "
          f"({os.path.getsize(out) / 1e6:.1f} MB, self-contained)")


if __name__ == "__main__":
    main()
