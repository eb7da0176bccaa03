"""Interactive motion viewer (port of ``kinpoly_tpu/utils/html_viewer.py``):
a dependency-free HTML/canvas replacement for the reference's GLFW viewer
(pause, speed, scrub; predicted and ground-truth humanoids side by side).

``export_html`` bakes FK'd joint trajectories (and object box poses) into
one self-contained HTML file: orbit with a mouse drag, zoom with the wheel,
space pauses, +/- change the speed, the arrows step one frame. It needs no
network and no external script. FK runs in float32 on the device, whatever
the input's dtype, and the joints are rounded to 4 decimals, as in the JAX
package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.physics import fk as fklib

# display colors per sequence (pred, gt, extra...)
COLORS = ("#2563eb", "#16a34a", "#dc2626", "#9333ea", "#d97706")


@torch.no_grad()
def _joints(spec, qpos_seq: np.ndarray, device=None) -> np.ndarray:
    dev = resolve_device(device)
    res = fklib.fk(spec_tensors(spec, torch.float32, dev),
                   torch.as_tensor(np.asarray(qpos_seq), dtype=torch.float32,
                                   device=dev))
    return res.xpos.cpu().numpy()                    # (T, 24, 3)


def _edges(spec):
    return [[int(p), i] for i, p in enumerate(spec.parents) if p >= 0]


def _object_boxes(spec):
    """Per scene object: list of (half-size, local offset) boxes for drawing
    (cylinders render as their bounding box)."""
    out = []
    for o in spec.objects:
        boxes = []
        for g in o.geoms:
            if g.gtype == "box":
                size = [float(s) for s in g.size[:3]]
            elif g.gtype == "cylinder":
                r, h = float(g.size[0]), float(g.size[1])
                size = [r, r, h]
            else:
                r = float(g.size[0])
                size = [r, r, r]
            boxes.append(dict(size=size, pos=[float(p) for p in g.pos]))
        out.append(dict(name=o.name, boxes=boxes))
    return out


def export_html(spec, sequences: dict[str, np.ndarray], out_path: str,
                obj_seq: np.ndarray | None = None, fps: int = 30,
                title: str = "kinpoly_tpu motion", device=None):
    """sequences: {label: (T, 76) qpos}. obj_seq: (T, n_obj, 7) world object
    poses (optional). Writes a self-contained interactive HTML viewer and
    returns out_path."""
    seqs = []
    T = None
    for i, (label, q) in enumerate(sequences.items()):
        q = np.asarray(q)
        T = q.shape[0] if T is None else min(T, q.shape[0])
        seqs.append(dict(label=label, color=COLORS[i % len(COLORS)],
                         joints=np.round(_joints(spec, q, device), 4).tolist()))
    data = dict(
        fps=fps, edges=_edges(spec), seqs=seqs, title=title,
        objects=_object_boxes(spec) if (obj_seq is not None and spec.objects) else [],
        obj_seq=(np.round(np.asarray(obj_seq), 4).tolist()
                 if obj_seq is not None else None),
    )
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>kinpoly_tpu viewer</title>
<style>
 body{margin:0;background:#0f172a;color:#e2e8f0;font:13px system-ui}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #bar{position:fixed;bottom:0;left:0;right:0;height:34px;background:#1e293b;
      display:flex;align-items:center;gap:10px;padding:0 12px}
 #scrub{flex:1} button{background:#334155;color:#e2e8f0;border:0;
      border-radius:4px;padding:4px 10px;cursor:pointer}
 .lg{display:inline-block;margin-right:12px}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
     margin-right:4px;vertical-align:-1px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">&#9208;</button>
 <input type="range" id="scrub" min="0" max="0" value="0">
 <span id="frame"></span>
 <button id="slower">-</button><span id="spd">1.0x</span><button id="faster">+</button>
</div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let az = -0.9, el = 0.35, dist = 5.0, cx = 0, cy = 0, cz = 0.9;
let t = 0, playing = true, speed = 1.0, acc = 0, last = performance.now();
const T = Math.min(...D.seqs.map(s => s.joints.length));
const scrub = document.getElementById('scrub'); scrub.max = T - 1;
function resize(){ cv.width = innerWidth; cv.height = innerHeight - 34; }
addEventListener('resize', resize); resize();
let hud = D.seqs.map(s => `<span class="lg"><span class="sw" style="background:${s.color}"></span>${s.label}</span>`).join('');
document.getElementById('hud').innerHTML = `<b>${D.title}</b> &nbsp; ${hud}
 <br><small>drag: orbit &nbsp; wheel: zoom &nbsp; space: pause &nbsp; &larr;/&rarr;: step &nbsp; +/-: speed</small>`;
function proj(p){
  const ca=Math.cos(az), sa=Math.sin(az), ce=Math.cos(el), se=Math.sin(el);
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let x1=ca*x+sa*y, y1=-sa*x+ca*y;           // yaw about z
  let y2=ce*y1+se*z, z2=-se*y1+ce*z;         // pitch
  const s = 0.8*Math.min(cv.width,cv.height)/dist/(1+y2/dist*0.4);
  return [cv.width/2+x1*s, cv.height/2-z2*s];
}
function box_corners(c,q,size,off){
  // rotate local box corners by quat q, translate by c
  const [w,x,y,z]=q; const R=[
   [1-2*(y*y+z*z),2*(x*y-w*z),2*(x*z+w*y)],
   [2*(x*y+w*z),1-2*(x*x+z*z),2*(y*z-w*x)],
   [2*(x*z-w*y),2*(y*z+w*x),1-2*(x*x+y*y)]];
  const pts=[];
  for(const sx of [-1,1]) for(const sy of [-1,1]) for(const sz of [-1,1]){
    const l=[off[0]+sx*size[0],off[1]+sy*size[1],off[2]+sz*size[2]];
    pts.push([c[0]+R[0][0]*l[0]+R[0][1]*l[1]+R[0][2]*l[2],
              c[1]+R[1][0]*l[0]+R[1][1]*l[1]+R[1][2]*l[2],
              c[2]+R[2][0]*l[0]+R[2][1]*l[1]+R[2][2]*l[2]]);
  }
  return pts;
}
const BOX_E=[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]];
function draw(){
  ctx.fillStyle='#0f172a'; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.strokeStyle='#1e293b';                    // floor grid
  for(let i=-5;i<=5;i++){
    let a=proj([i,-5,0]), b=proj([i,5,0]); ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
    a=proj([-5,i,0]); b=proj([5,i,0]); ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
  }
  if(D.obj_seq){
    ctx.strokeStyle='#f59e0b';
    const of=D.obj_seq[Math.min(t,D.obj_seq.length-1)];
    D.objects.forEach((o,i)=>{
      const p=of[i]; if(Math.abs(p[0])>20||Math.abs(p[1])>20) return; // parked
      for(const b of o.boxes){
        const pts=box_corners([p[0],p[1],p[2]],[p[3],p[4],p[5],p[6]],b.size,b.pos)
          .map(proj);
        for(const [u,v] of BOX_E){ctx.beginPath();ctx.moveTo(pts[u][0],pts[u][1]);
          ctx.lineTo(pts[v][0],pts[v][1]);ctx.stroke();}
      }
    });
  }
  for(const s of D.seqs){
    const J=s.joints[t].map(proj);
    ctx.strokeStyle=s.color; ctx.lineWidth=2.5;
    for(const [a,b] of D.edges){ctx.beginPath();ctx.moveTo(J[a][0],J[a][1]);
      ctx.lineTo(J[b][0],J[b][1]);ctx.stroke();}
    ctx.fillStyle=s.color;
    for(const p of J){ctx.beginPath();ctx.arc(p[0],p[1],3,0,7);ctx.fill();}
  }
  document.getElementById('frame').textContent=`${t+1}/${T}`;
  scrub.value=t;
}
function tick(now){
  const dt=(now-last)/1000; last=now;
  if(playing){ acc+=dt*D.fps*speed; while(acc>=1){t=(t+1)%T;acc-=1;} }
  draw(); requestAnimationFrame(tick);
}
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{ if(drag){az+=(e.clientX-drag[0])*0.008;
  el=Math.max(-1.4,Math.min(1.4,el+(e.clientY-drag[1])*0.008)); drag=[e.clientX,e.clientY];}});
cv.addEventListener('wheel',e=>{dist=Math.max(1,Math.min(30,dist*(1+e.deltaY*0.001)));e.preventDefault()});
addEventListener('keydown',e=>{
  if(e.code==='Space'){playing=!playing;}
  else if(e.key==='ArrowRight'){playing=false;t=(t+1)%T;}
  else if(e.key==='ArrowLeft'){playing=false;t=(t-1+T)%T;}
  else if(e.key==='+'||e.key==='='){speed=Math.min(8,speed*1.25);}
  else if(e.key==='-'){speed=Math.max(0.125,speed/1.25);}
  document.getElementById('spd').textContent=speed.toFixed(2)+'x';
});
document.getElementById('play').onclick=()=>playing=!playing;
document.getElementById('slower').onclick=()=>{speed=Math.max(0.125,speed/1.25);document.getElementById('spd').textContent=speed.toFixed(2)+'x';};
document.getElementById('faster').onclick=()=>{speed=Math.min(8,speed*1.25);document.getElementById('spd').textContent=speed.toFixed(2)+'x';};
scrub.addEventListener('input',()=>{playing=false;t=+scrub.value;});
requestAnimationFrame(tick);
</script></body></html>
"""
