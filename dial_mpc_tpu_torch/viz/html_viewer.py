"""Standalone HTML trajectory viewer (no external assets, no CDN).

One self-contained HTML file: the geometry of a MuJoCo model (spheres,
capsules, cylinders, boxes, planes, and meshes decimated by vertex
clustering) and each frame's geom poses are embedded as JSON and drawn by a
small built-in WebGL engine with an orbit camera and a play/pause timeline.

The poses come from CPU MuJoCo kinematics (host side, offline), so the
functions take a ``mujoco.MjModel`` and import ``mujoco`` when they run:
this module imports on a machine without it.
"""

from __future__ import annotations

import json

import numpy as np

_GEOM_TYPES = {2: "sphere", 3: "capsule", 5: "cylinder", 6: "box", 0: "plane"}


def _collect_frames(mj_model, qpos_traj):
    import mujoco

    data = mujoco.MjData(mj_model)
    frames = []
    for q in qpos_traj:
        data.qpos[:] = q
        mujoco.mj_kinematics(mj_model, data)
        frames.append(
            np.concatenate(
                [data.geom_xpos.copy(), data.geom_xmat.reshape(-1, 9).copy()],
                axis=1,
            ).astype(np.float32)
        )
    return np.stack(frames)  # (T, ngeom, 12)


def _geoms(mj_model):
    out = []
    for g in range(mj_model.ngeom):
        typ = _GEOM_TYPES.get(int(mj_model.geom_type[g]))
        entry = None
        if typ is None and int(mj_model.geom_type[g]) == 7:  # mjGEOM_MESH
            typ = "mesh"
            entry = int(mj_model.geom_dataid[g])
        elif typ is None:
            # unsupported primitive: bounding box fallback
            typ = "box"
        rgba = mj_model.geom_rgba[g].tolist()
        if rgba[3] == 0.0:
            continue
        item = {
            "id": g,
            "type": typ,
            "size": mj_model.geom_size[g].tolist(),
            "rgba": rgba,
        }
        if entry is not None:
            item["mid"] = entry
        out.append(item)
    return out


def _decimate(verts, faces, target_faces):
    """Vertex-clustering decimation: snap vertices to a uniform grid, merge
    clusters, drop degenerate/duplicate faces. Dependency-free and fast;
    fidelity is ample for a trajectory viewer."""
    if len(faces) <= target_faces:
        return verts, faces
    bbmin = verts.min(axis=0)
    extent = float((verts.max(axis=0) - bbmin).max()) or 1.0
    best = None
    for res in (96, 72, 56, 44, 34, 26, 20, 14, 10, 7):
        cell = extent / res
        key = np.floor((verts - bbmin) / cell).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        reps = np.zeros((len(uniq), 3))
        np.add.at(reps, inv, verts)
        counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        reps /= counts[:, None]
        f2 = inv[faces]
        good = (
            (f2[:, 0] != f2[:, 1])
            & (f2[:, 1] != f2[:, 2])
            & (f2[:, 0] != f2[:, 2])
        )
        f2 = f2[good]
        fs = np.sort(f2, axis=1)
        _, ui = np.unique(fs, axis=0, return_index=True)
        f2 = f2[np.sort(ui)]
        best = (reps.astype(np.float32), f2)
        if len(f2) <= target_faces:
            break
    return best


def _mesh_library(mj_model, used_mids, target_faces=1500):
    """id -> flat [px,py,pz,nx,ny,nz] x 3 verts per face (non-indexed,
    flat-shaded), decimated. Geometry comes straight from the compiled
    model (mesh_vert/mesh_face are already in the geom frame)."""
    lib = {}
    for mid in sorted(used_mids):
        va, vn = int(mj_model.mesh_vertadr[mid]), int(mj_model.mesh_vertnum[mid])
        fa, fn = int(mj_model.mesh_faceadr[mid]), int(mj_model.mesh_facenum[mid])
        verts = mj_model.mesh_vert[va : va + vn].astype(np.float64)
        faces = mj_model.mesh_face[fa : fa + fn].astype(np.int64)
        verts, faces = _decimate(verts, faces, target_faces)
        tri = verts[faces]  # (F, 3, 3)
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        flat = np.concatenate(
            [tri, np.repeat(n[:, None, :], 3, axis=1)], axis=2
        )  # (F, 3, 6)
        lib[str(mid)] = np.round(flat.reshape(-1), 4).tolist()
    return lib


def render_trajectory(mj_model, qpos_traj, path, fps=50.0, decimate=1):
    """Write the viewer of the (T, nq) qpos rows, every ``decimate``-th
    shown at ``fps / decimate`` frames a second, to ``path``; returns it."""
    qpos_traj = np.asarray(qpos_traj)[::decimate]
    frames = _collect_frames(mj_model, qpos_traj)
    geoms = _geoms(mj_model)
    keep = [g["id"] for g in geoms]
    frames = frames[:, keep, :]
    meshlib = _mesh_library(
        mj_model, {g["mid"] for g in geoms if g["type"] == "mesh"}
    )
    payload = {
        "fps": fps / decimate,
        "geoms": geoms,
        "meshlib": meshlib,
        "frames": np.round(frames, 4).tolist(),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dial-mpc-tpu trajectory</title>
<style>
 body{margin:0;background:#101318;color:#cfd6e4;font-family:system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;left:12px;top:10px;z-index:2;font-size:13px;user-select:none}
 #bar{position:fixed;left:0;right:0;bottom:0;padding:10px 14px;background:#171b22cc;display:flex;gap:10px;align-items:center}
 #t{flex:1}
 button{background:#2a3240;color:#dfe6f2;border:0;border-radius:6px;padding:6px 12px;cursor:pointer}
</style></head><body>
<div id="hud">dial-mpc-tpu viewer &mdash; drag: orbit, wheel: zoom, shift-drag: pan</div>
<canvas id="c"></canvas>
<div id="bar"><button id="play">Pause</button><input id="t" type="range" min="0" value="0" step="1"><span id="info"></span></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
function resize(){cv.width=innerWidth;cv.height=innerHeight-0;gl.viewport(0,0,cv.width,cv.height);}
addEventListener('resize',resize);resize();
const VS=`attribute vec3 p;attribute vec3 n;uniform mat4 mvp;uniform mat4 mv;varying vec3 vn;varying vec3 vp;
void main(){gl_Position=mvp*vec4(p,1.0);vn=mat3(mv[0].xyz,mv[1].xyz,mv[2].xyz)*n;vp=(mv*vec4(p,1.0)).xyz;}`;
const FS=`precision mediump float;uniform vec4 col;varying vec3 vn;varying vec3 vp;
void main(){vec3 N=normalize(vn);vec3 L=normalize(vec3(0.5,0.8,1.0));float d=max(dot(N,L),0.0);
float a=0.35;vec3 c=col.rgb*(a+0.75*d)+vec3(1.0)*pow(max(dot(reflect(-L,N),normalize(-vp)),0.0),24.0)*0.15;
gl_FragColor=vec4(c,col.a);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);return o;}
const prog=gl.createProgram();gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);gl.enable(gl.DEPTH_TEST);
const loc={p:gl.getAttribLocation(prog,'p'),n:gl.getAttribLocation(prog,'n'),mvp:gl.getUniformLocation(prog,'mvp'),mv:gl.getUniformLocation(prog,'mv'),col:gl.getUniformLocation(prog,'col')};
// ---- mesh builders (positions+normals interleaved) ----
function mesh(v){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(v),gl.STATIC_DRAW);return{b:b,n:v.length/6};}
function uvSphere(r,zs,ze,zoff,lat=10,lon=16){const v=[];for(let i=0;i<lat;i++){const t0=zs+(ze-zs)*i/lat,t1=zs+(ze-zs)*(i+1)/lat;
for(let j=0;j<lon;j++){const p0=2*Math.PI*j/lon,p1=2*Math.PI*(j+1)/lon;
const pt=(t,p)=>[r*Math.cos(p)*Math.cos(t),r*Math.sin(p)*Math.cos(t),r*Math.sin(t)+zoff];
const nr=(t,p)=>[Math.cos(p)*Math.cos(t),Math.sin(p)*Math.cos(t),Math.sin(t)];
const q=[[t0,p0],[t1,p0],[t1,p1],[t0,p0],[t1,p1],[t0,p1]];
for(const[a,b2]of q){v.push(...pt(a,b2),...nr(a,b2));}}}return v;}
function cylSide(r,h,lon=16){const v=[];for(let j=0;j<lon;j++){const p0=2*Math.PI*j/lon,p1=2*Math.PI*(j+1)/lon;
const pt=(p,z)=>[r*Math.cos(p),r*Math.sin(p),z];const nr=p=>[Math.cos(p),Math.sin(p),0];
const q=[[p0,-h],[p0,h],[p1,h],[p0,-h],[p1,h],[p1,-h]];for(const[p,z]of q){v.push(...pt(p,z),...nr(p));}}return v;}
function boxMesh(sx,sy,sz){const f=[[1,0,0],[-1,0,0],[0,1,0],[0,-1,0],[0,0,1],[0,0,-1]];const v=[];
for(const n of f){const u=[n[1],n[2],n[0]],w=[n[2],n[0],n[1]];
const c=(a,b2)=>[(n[0]+a*u[0]+b2*w[0])*sx,(n[1]+a*u[1]+b2*w[1])*sy,(n[2]+a*u[2]+b2*w[2])*sz];
const q=[c(-1,-1),c(1,-1),c(1,1),c(-1,-1),c(1,1),c(-1,1)];for(const p of q){v.push(...p,...n);}}return v;}
function planeMesh(s){const e=s>0?s:12;return boxMesh(e,e,0.005);}
const meshes=DATA.geoms.map(g=>{
 if(g.type=='sphere')return mesh(uvSphere(g.size[0],-Math.PI/2,Math.PI/2,0));
 if(g.type=='capsule'){const r=g.size[0],h=g.size[1];
   return mesh([...cylSide(r,h),...uvSphere(r,0,Math.PI/2,h),...uvSphere(r,-Math.PI/2,0,-h)]);}
 if(g.type=='cylinder')return mesh([...cylSide(g.size[0],g.size[1]),...boxMesh(0,0,0)]);
 if(g.type=='plane')return mesh(planeMesh(g.size[0]));
 if(g.type=='mesh')return mesh(DATA.meshlib[g.mid]);
 return mesh(boxMesh(g.size[0]||.05,g.size[1]||.05,g.size[2]||.05));});
// ---- matrices ----
function mul(a,b){const o=new Array(16).fill(0);for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)o[j*4+i]+=a[k*4+i]*b[j*4+k];return o;}
function persp(fy,ar,n,f){const t=1/Math.tan(fy/2);return[t/ar,0,0,0,0,t,0,0,0,0,(f+n)/(n-f),-1,0,0,2*f*n/(n-f),0];}
function lookAt(e,c,u){const z=norm3(sub3(e,c)),x=norm3(cross3(u,z)),y=cross3(z,x);
return[x[0],y[0],z[0],0,x[1],y[1],z[1],0,x[2],y[2],z[2],0,-dot3(x,e),-dot3(y,e),-dot3(z,e),1];}
const sub3=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]],cross3=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
const dot3=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2],norm3=a=>{const l=Math.hypot(...a);return[a[0]/l,a[1]/l,a[2]/l];};
// ---- state ----
let az=0.9,el=0.45,dist=2.6,tgt=[0,0,0.3],playing=true,fi=0;
const T=DATA.frames.length;document.getElementById('t').max=T-1;
cv.addEventListener('mousedown',e=>{let lx=e.clientX,ly=e.clientY;const mm=ev=>{const dx=ev.clientX-lx,dy=ev.clientY-ly;lx=ev.clientX;ly=ev.clientY;
 if(ev.shiftKey){const s=dist*0.0015;tgt[0]-=s*(Math.cos(az)*dx*-1+0);tgt[1]-=s*(Math.sin(az)*dx);tgt[2]+=s*dy;}
 else{az-=dx*0.008;el=Math.min(1.5,Math.max(-0.2,el+dy*0.008));}};
 const up=()=>{removeEventListener('mousemove',mm);removeEventListener('mouseup',up);};
 addEventListener('mousemove',mm);addEventListener('mouseup',up);});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
document.getElementById('play').onclick=function(){playing=!playing;this.textContent=playing?'Pause':'Play';};
document.getElementById('t').oninput=function(){fi=+this.value;playing=false;document.getElementById('play').textContent='Play';};
// auto-follow: track mean of first mobile geom
function draw(){
 const f=DATA.frames[Math.floor(fi)];
 const eye=[tgt[0]+dist*Math.cos(el)*Math.cos(az),tgt[1]+dist*Math.cos(el)*Math.sin(az),tgt[2]+dist*Math.sin(el)];
 const V=lookAt(eye,tgt,[0,0,1]);const P=persp(0.9,cv.width/cv.height,0.02,100);
 gl.clearColor(0.063,0.075,0.094,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 for(let i=0;i<DATA.geoms.length;i++){
  const g=DATA.geoms[i],d=f[i];
  const M=[d[3],d[6],d[9],0,d[4],d[7],d[10],0,d[5],d[8],d[11],0,d[0],d[1],d[2],1];
  const MV=mul(V,M);
  gl.uniformMatrix4fv(loc.mv,false,MV);gl.uniformMatrix4fv(loc.mvp,false,mul(P,MV));
  gl.uniform4fv(loc.col,g.rgba);
  const m=meshes[i];gl.bindBuffer(gl.ARRAY_BUFFER,m.b);
  gl.enableVertexAttribArray(loc.p);gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,24,0);
  gl.enableVertexAttribArray(loc.n);gl.vertexAttribPointer(loc.n,3,gl.FLOAT,false,24,12);
  gl.drawArrays(gl.TRIANGLES,0,m.n);}
 if(playing){fi+=1;if(fi>=T)fi=0;document.getElementById('t').value=Math.floor(fi);}
 document.getElementById('info').textContent=`frame ${Math.floor(fi)+1}/${T}`;
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
</script></body></html>
"""
