"""Live map viewer: an HTTP thread in the process and a WebGL page.

A daemon thread serves a single-file WebGL point-cloud page (no external
scripts: it must work without network access) and a binary snapshot of
the map, `/map.bin`, which the page polls every two seconds.  A snapshot
is read from the device when it is requested, so an unobserved viewer
costs the tracking loop nothing; a request reads the buffers while the
loop may be writing them, so a snapshot can mix two updates.

Binary layout of /map.bin (little-endian), the JAX package's:
    int32 n_points, int32 n_cams,
    float32 points[n_points, 3], uint8 colors[n_points, 3],
    zero padding to a multiple of 4 bytes,
    float32 cams[n_cams, 7]  (c2w [tx ty tz qx qy qz qw])
`/stats` answers {"points": N, "keyframes": M}.
"""

import json
import struct
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .visualization import filtered_map

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>droid_slam_tpu_torch live map</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 10px;
      border-radius:4px;pointer-events:none}
 canvas{display:block}
</style></head><body>
<div id="hud">connecting…</div><canvas id="c"></canvas>
<script>
"use strict";
const canvas=document.getElementById("c"),hud=document.getElementById("hud");
const gl=canvas.getContext("webgl",{antialias:false});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);
gl_PointSize=2.0;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,"p"),
      locC=gl.getAttribLocation(prog,"col"),
      locM=gl.getUniformLocation(prog,"mvp");
const bufP=gl.createBuffer(),bufC=gl.createBuffer(),
      bufL=gl.createBuffer();
let nPts=0,nLine=0,center=[0,0,0],radius=4;
// orbit state
let yaw=-0.6,pitch=-0.5,dist=6,panX=0,panY=0,drag=0,lx=0,ly=0;
canvas.onmousedown=e=>{drag=e.button===2?2:1;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=0;
window.oncontextmenu=e=>e.preventDefault();
window.onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
 if(drag===1){yaw+=dx*0.006;pitch+=dy*0.006;}
 else{panX-=dx*0.0015*dist;panY+=dy*0.0015*dist;}
 lx=e.clientX;ly=e.clientY;};
window.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);};
function mat(){
 const cw=canvas.width,ch=canvas.height,a=cw/ch,f=1.6,n=0.01,fa=1000;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
       sp=Math.sin(pitch);
 // camera position on orbit sphere around center+pan
 const cx=center[0]+panX,cyy=center[1]+panY,cz=center[2];
 const ex=cx+dist*cy*cp,ey=cyy+dist*sp,ez=cz+dist*sy*cp;
 // look-at
 let zx=ex-cx,zy=ey-cyy,zz=ez-cz;const zl=Math.hypot(zx,zy,zz);
 zx/=zl;zy/=zl;zz/=zl;
 let xx=-zz,xy=0,xz=zx;const xl=Math.hypot(xx,xy,xz)||1;
 xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tx=-(xx*ex+xy*ey+xz*ez),ty=-(yx*ex+yy*ey+yz*ez),
       tz=-(zx*ex+zy*ey+zz*ez);
 const p00=f/a,p11=f,p22=(fa+n)/(n-fa),p23=2*fa*n/(n-fa);
 return new Float32Array([
  p00*xx,p11*yx,p22*zx,-zx, p00*xy,p11*yy,p22*zy,-zy,
  p00*xz,p11*yz,p22*zz,-zz, p00*tx,p11*ty,p22*tz+p23,-tz]);
}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(locM,false,mat());
 if(nPts){
  gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
  gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(gl.POINTS,0,nPts);}
 if(nLine){
  gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.disableVertexAttribArray(locC);
  gl.vertexAttrib3f(locC,0.35,0.85,0.45);
  gl.drawArrays(gl.LINES,0,nLine);}
 requestAnimationFrame(draw);
}
function qrot(q,v){ // rotate v by quaternion [x,y,z,w]
 const x=q[0],y=q[1],z=q[2],w=q[3];
 const cx=2*(y*v[2]-z*v[1]),cy=2*(z*v[0]-x*v[2]),cz=2*(x*v[1]-y*v[0]);
 return [v[0]+w*cx+y*cz-z*cy, v[1]+w*cy+z*cx-x*cz,
         v[2]+w*cz+x*cy-y*cx];
}
async function poll(){
 try{
  const r=await fetch("map.bin",{cache:"no-store"});
  const ab=await r.arrayBuffer();const dv=new DataView(ab);
  const np_=dv.getInt32(0,true),nc=dv.getInt32(4,true);
  let off=8;
  const pts=new Float32Array(ab,off,np_*3);off+=np_*12;
  const col=new Uint8Array(ab,off,np_*3);off+=np_*3;
  if(off%4)off+=4-off%4;
  const cams=new Float32Array(ab,off,nc*7);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufP);
  gl.bufferData(gl.ARRAY_BUFFER,pts,gl.DYNAMIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER,bufC);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.DYNAMIC_DRAW);
  nPts=np_;
  // camera frusta wireframes
  const L=[];const s=0.12;
  const corners=[[-s,-s*0.75,s*1.2],[s,-s*0.75,s*1.2],
                 [s,s*0.75,s*1.2],[-s,s*0.75,s*1.2]];
  for(let i=0;i<nc;i++){
   const t=[cams[7*i],cams[7*i+1],cams[7*i+2]];
   const q=[cams[7*i+3],cams[7*i+4],cams[7*i+5],cams[7*i+6]];
   const cw=corners.map(c=>{const r2=qrot(q,c);
    return [r2[0]+t[0],r2[1]+t[1],r2[2]+t[2]];});
   for(let k=0;k<4;k++){
    L.push(...t,...cw[k]);L.push(...cw[k],...cw[(k+1)%4]);}
   if(i+1<nc)L.push(cams[7*i],cams[7*i+1],cams[7*i+2],
                    cams[7*i+7],cams[7*i+8],cams[7*i+9]);
  }
  gl.bindBuffer(gl.ARRAY_BUFFER,bufL);
  gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(L),gl.DYNAMIC_DRAW);
  nLine=L.length/3;
  if(np_>0){let mx=0,my=0,mz=0;
   for(let i=0;i<np_;i++){mx+=pts[3*i];my+=pts[3*i+1];mz+=pts[3*i+2];}
   center=[mx/np_,my/np_,mz/np_];}
  hud.textContent=`${np_} points · ${nc} keyframes`;
 }catch(e){hud.textContent="waiting for map… "+e;}
 setTimeout(poll,2000);
}
draw();poll();
</script></body></html>"""


def map_snapshot(video, filter_thresh=0.005, min_count=2):
    """(points (N, 3) f32, colors (N, 3) uint8, keyframe c2w poses (M, 7)
    f32) of a DepthVideo, filtered as `export_point_cloud` filters."""
    if video.counter == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8),
                np.zeros((0, 7), np.float32))
    return filtered_map(video, filter_thresh, min_count)


def encode_map(pts, col, cams):
    """The /map.bin bytes of a snapshot."""
    pts = np.ascontiguousarray(pts, np.float32)
    colb = np.ascontiguousarray(col, np.uint8).tobytes()
    pad = b"\0" * ((4 - (8 + pts.nbytes + len(colb)) % 4) % 4)
    return (struct.pack("<ii", len(pts), len(cams)) + pts.tobytes() + colb
            + pad + np.ascontiguousarray(cams, np.float32).tobytes())


def decode_map(raw):
    """(points, colors, cams) from /map.bin bytes."""
    n_pts, n_cams = struct.unpack_from("<ii", raw, 0)
    off = 8
    pts = np.frombuffer(raw, np.float32, n_pts * 3, off).reshape(n_pts, 3)
    off += n_pts * 12
    col = np.frombuffer(raw, np.uint8, n_pts * 3, off).reshape(n_pts, 3)
    off += n_pts * 3
    off += (4 - off % 4) % 4
    cams = np.frombuffer(raw, np.float32, n_cams * 7, off).reshape(n_cams, 7)
    return pts, col, cams


class LiveViewer:
    """Daemon HTTP server of live map snapshots.

    snapshot_fn() -> (points (N, 3) f32, colors (N, 3) uint8, cams (M, 7)
    f32), called once per request.
    """

    def __init__(self, snapshot_fn, port=8080, host="127.0.0.1"):
        # loopback by default: the snapshot exposes the reconstructed map
        # and keyframe colours; pass host="0.0.0.0" to serve other hosts
        self.snapshot_fn = snapshot_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # no per-request logging
                pass

            def _send(self, body, ctype):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _snapshot(self):
                try:
                    return outer.snapshot_fn()
                except Exception:         # the server keeps serving
                    traceback.print_exc(file=sys.stderr)
                    return (np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.uint8),
                            np.zeros((0, 7), np.float32))

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif self.path.startswith("/map.bin"):
                    self._send(encode_map(*self._snapshot()),
                               "application/octet-stream")
                elif self.path.startswith("/stats"):
                    pts, _, cams = self._snapshot()
                    self._send(json.dumps({"points": len(pts),
                                           "keyframes": len(cams)}).encode(),
                               "application/json")
                else:
                    self.send_error(404)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def start_viewer(video, port=8080, host="127.0.0.1", **filter_kw):
    """Serve a live view of a DepthVideo's map (port 0: any free port);
    returns the LiveViewer."""
    viewer = LiveViewer(lambda: map_snapshot(video, **filter_kw), port=port,
                        host=host)
    print(f"live map viewer: http://{host}:{viewer.port}/", flush=True)
    return viewer
