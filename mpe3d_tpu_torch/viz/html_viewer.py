"""Interactive 3D skeleton viewer as one self-contained HTML file.

Port of ``mpe3d_tpu/viz/html_viewer.py`` (``_frame_payload`` :36,
``write_html_viewer`` :52, ``build_viewer_html`` :100, the page template
:115), plain Python: the file a given sequence writes is the JAX
package's, byte for byte.  The page (vanilla JS on a 2D canvas, no network)
orbits, zooms and pans, plays and scrubs the frames, colours persons by
track id, labels the quality column, and draws GT dashed and the rig's
cameras, in the rig's display axes.  Poses are embedded as rounded-mm
JSON.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from mpe3d_tpu_torch.config import COCO_BONES, RigConfig
from mpe3d_tpu_torch.viz.viewer import VIEW_LIM, remap_axes

# matplotlib tab10, as hex, so colours match the GIF renderer
_HEX_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
               "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def _frame_payload(poses: np.ndarray, gt: Optional[np.ndarray],
                   track_ids: Optional[np.ndarray],
                   quality: Optional[np.ndarray]) -> dict:
    def _round(a):
        return np.round(np.asarray(a, np.float64), 3).tolist()

    d = {"p": _round(poses) if len(poses) else []}
    if gt is not None and len(gt):
        d["g"] = _round(gt)
    if track_ids is not None and len(track_ids):
        d["id"] = np.asarray(track_ids).astype(int).tolist()
    if quality is not None and len(quality):
        d["q"] = np.round(np.asarray(quality, np.float64), 1).tolist()
    return d


def write_html_viewer(frames_poses: List[np.ndarray], rig_config: RigConfig,
                      out_path: str,
                      frames_gt: Optional[List[np.ndarray]] = None,
                      frames_track_ids: Optional[List[np.ndarray]] = None,
                      frames_quality: Optional[List[np.ndarray]] = None,
                      camera_centers: Optional[np.ndarray] = None,
                      fps: int = 10,
                      title: str = "mpe3d_tpu results") -> str:
    """Write an interactive single-file HTML viewer for [P, J, 3] world-space
    pose sequences.  Axis remap (rig_config.axes_3d) is applied here, like
    ``render_sequence``; GT/track/quality overlays mirror the GIF renderer's.
    ``camera_centers`` ([C, 3] world coords, e.g. ``rig.camera_centers()``)
    draws the capture rig.  Returns ``out_path``.
    """
    display = [remap_axes(np.asarray(p, np.float64), rig_config)
               if len(p) else np.zeros((0, 0, 3)) for p in frames_poses]
    n = len(display)
    gts = frames_gt if frames_gt is not None else [None] * n
    gts = [remap_axes(np.asarray(g, np.float64), rig_config)
           if g is not None and len(g) else None for g in gts]
    tids = frames_track_ids if frames_track_ids else [None] * n
    quals = frames_quality if frames_quality else [None] * n

    # all overlay lists are length-guarded: callers may collect GT/ids/
    # quality only for a prefix of the frames
    frames = [_frame_payload(display[i],
                             gts[i] if i < len(gts) else None,
                             tids[i] if i < len(tids) else None,
                             quals[i] if i < len(quals) else None)
              for i in range(n)]
    cams = (np.round(remap_axes(np.asarray(camera_centers, np.float64),
                                rig_config), 3).tolist()
            if camera_centers is not None and len(camera_centers) else [])
    payload = {
        "frames": frames,
        "bones": [list(b) for b in COCO_BONES],
        "colors": _HEX_COLORS,
        "cams": cams,
        "lim": VIEW_LIM,
        "fps": int(fps),
        "axes": [lbl for lbl, _ in rig_config.axes_3d],
        "title": title,
    }
    with open(out_path, "w") as f:
        f.write(build_viewer_html(payload, title))
    return out_path


def build_viewer_html(payload: dict, title: str, live_js: str = "") -> str:
    """Assemble the viewer page from a payload dict — ONE place for the
    markup escaping rules (shared with viz/live_viewer.py so the static
    and live viewers cannot drift).  The title and the '</' sequences in
    the inline JSON are escaped: a title like 'a</script>b.json' (it
    comes from a file name) would otherwise terminate the <script> block
    mid-payload."""
    import html as _html
    data = json.dumps(payload, separators=(",", ":")).replace("</", "<\\/")
    return (_TEMPLATE
            .replace("__TITLE__", _html.escape(title))
            .replace("__DATA__", data)
            .replace("__LIVE_JS__", live_js))


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;z-index:2}
 #bar{position:fixed;left:0;right:0;bottom:0;padding:8px 12px;
      background:#1b1b1bcc;display:flex;gap:10px;align-items:center}
 #frameno{min-width:90px}
 input[type=range]{flex:1}
 button{background:#333;color:#ddd;border:1px solid #555;border-radius:4px;
        padding:3px 10px;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan &middot; space: play/pause</div>
<canvas id="c"></canvas>
<div id="bar">
 <button id="play">&#9654;</button>
 <span id="frameno"></span>
 <input type="range" id="seek" min="0" value="0" step="1">
 <label>speed <select id="speed">
   <option>0.25</option><option>0.5</option><option selected>1</option>
   <option>2</option><option>4</option></select></label>
</div>
<script>
const D=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-0.8,pitch=0.45,dist=3.2*D.lim,panX=0,panY=0,fi=0,playing=false;
const seek=document.getElementById('seek');seek.max=Math.max(0,D.frames.length-1);
function resize(){cv.width=innerWidth;cv.height=innerHeight-46;draw();}
addEventListener('resize',resize);
function proj(p){ // world(display) -> screen, z-up orbit camera
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const x=p[0]*cy-p[1]*sy, y=p[0]*sy+p[1]*cy, z=p[2]-D.lim*0.4;
  const Y=y*cp-z*sp, Z=y*sp+z*cp+dist;
  const f=0.9*Math.min(cv.width,cv.height)/(Z>0.1?Z:0.1)*D.lim*0.55;
  return [cv.width/2+x*f+panX, cv.height/2-Y*f+panY, Z];
}
function line(a,b,color,w,dash){const A=proj(a),B=proj(b);
  if(A[2]<0.1||B[2]<0.1)return;
  ctx.strokeStyle=color;ctx.lineWidth=w;ctx.setLineDash(dash||[]);
  ctx.beginPath();ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();
  ctx.setLineDash([]);}
function drawGrid(){const L=D.lim;
  for(let i=-4;i<=4;i++){const t=i*L/4;
    line([t,-L,0],[t,L,0],'#2a2a2a',1);line([-L,t,0],[L,t,0],'#2a2a2a',1);}
  line([0,0,0],[L*0.5,0,0],'#a44',2);line([0,0,0],[0,L*0.5,0],'#4a4',2);
  line([0,0,0],[0,0,L*0.5],'#46c',2);
  ctx.fillStyle='#888';
  const ax=[[L*0.55,0,0],[0,L*0.55,0],[0,0,L*0.55]];
  for(let i=0;i<3;i++){const P=proj(ax[i]);
    if(P[2]>0.1)ctx.fillText(D.axes[i]||'XYZ'[i],P[0],P[1]);}
}
function drawSkel(p,color,dash,w){
  for(const[a,b]of D.bones){
    if(valid(p[a])&&valid(p[b]))line(p[a],p[b],color,w||2,dash);}
  ctx.fillStyle=color;
  for(const j of p){if(!valid(j))continue;const P=proj(j);
    if(P[2]>0.1){ctx.beginPath();ctx.arc(P[0],P[1],2.5,0,7);ctx.fill();}}
}
function valid(j){return j&&(j[0]||j[1]||j[2]);}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  drawGrid();
  for(const c of D.cams){const P=proj(c);if(P[2]<0.1)continue;
    ctx.strokeStyle='#888';ctx.strokeRect(P[0]-4,P[1]-3,8,6);
    ctx.fillStyle='#666';ctx.fillText('cam',P[0]+6,P[1]);}
  const F=D.frames[fi];if(!F)return;
  if(F.g)for(const g of F.g)drawSkel(g,'#999',[4,4],1);
  (F.p||[]).forEach((p,i)=>{
    const id=F.id?F.id[i]:i,color=D.colors[((id%10)+10)%10];
    drawSkel(p,color);
    let lbl=[];if(F.id)lbl.push('id '+id);
    if(F.q&&F.q[i]>=0)lbl.push(F.q[i]+'px');
    if(lbl.length){let top=null;for(const j of p)if(valid(j)&&(!top||j[2]>top[2]))top=j;
      if(top){const P=proj([top[0],top[1],top[2]+0.1]);
        if(P[2]>0.1){ctx.fillStyle=color;ctx.textAlign='center';
          ctx.fillText(lbl.join(' '),P[0],P[1]);ctx.textAlign='left';}}}
  });
  document.getElementById('frameno').textContent=
    'frame '+fi+' / '+(D.frames.length-1);
  seek.value=fi;
}
let drag=null;
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  if(drag[2]){panX+=dx;panY+=dy;}
  else{yaw+=dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
  drag=[e.clientX,e.clientY,drag[2]];draw();});
cv.addEventListener('wheel',e=>{e.preventDefault();
  dist=Math.max(0.5,dist*(e.deltaY>0?1.1:0.9));draw();},{passive:false});
seek.addEventListener('input',()=>{fi=+seek.value;draw();});
const playBtn=document.getElementById('play');
function setPlay(v){playing=v;playBtn.innerHTML=v?'&#10074;&#10074;':'&#9654;';}
playBtn.addEventListener('click',()=>setPlay(!playing));
addEventListener('keydown',e=>{if(e.code==='Space'){e.preventDefault();
  setPlay(!playing);}});
let last=0;
function tick(t){const sp=+document.getElementById('speed').value;
  if(playing&&D.frames.length&&t-last>1000/(D.fps*sp)){
    fi=(fi+1)%D.frames.length;last=t;draw();}
  requestAnimationFrame(tick);}
resize();requestAnimationFrame(tick);
__LIVE_JS__
</script></body></html>
"""
