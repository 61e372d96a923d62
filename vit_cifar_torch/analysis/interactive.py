"""Interactive attention dashboard — one self-contained HTML page, no
server; as ``vit_cifar_tpu/analysis/interactive.py``, whose viewer (HTML
and JS) this module keeps its own copy of.

Reference: dashboard.py, a Streamlit app whose *interactivity* is the point
(dashboard.py:77-236): a model picker over ``models/``, image selector,
token radio (all / <CLS> / choose), transpose toggle, head mode (all heads /
average / choose), colormap + interpolation + alpha controls, and side-by-side
Joint Attentions (rollout) vs Attention Maps, optionally overlaid on the
input.  Streamlit is not in this image, so the same exploration workflow
ships as static files: ``generate_interactive`` embeds the attention tensors
(uint8-quantized per map, base64) in per-model ``data_*.js`` files plus an
``index.html`` viewer whose selectors re-render client-side on a <canvas> —
no recomputation, no server, works from file://.

The rollout math in JS mirrors ``get_joint_attentions``
(attention/utils.py:70-105): add identity, row-normalize, cumulative matmul —
applied AFTER the transpose/head transforms, as the Streamlit app transforms
``attention_maps`` before rendering both columns.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

from .attention_maps import collect_attention_maps
from .run_model import load_run_model


def _quantize(attn: np.ndarray):
    """(L,B,H,T,T) float -> per-map uint8 + (L,B,H,2) min/max scales."""
    L, B, H, T, _ = attn.shape
    flat = attn.reshape(L * B * H, T * T)
    lo = flat.min(axis=1)
    hi = flat.max(axis=1)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.round((flat - lo[:, None]) / span[:, None] * 255.0).astype(np.uint8)
    scales = np.stack([lo, hi], axis=1).astype(np.float32)
    return q.reshape(-1), scales.reshape(-1)


def model_payload(ckpt: str, batch_size: int = 8, device="cuda") -> dict:
    """Everything the client-side viewer needs for one checkpoint; the
    forward runs on ``device`` (default the card)."""
    _, cfg, imgs, logits, inter = load_run_model(ckpt, batch_size=batch_size,
                                                 device=device)
    attn = collect_attention_maps(inter)  # (L,B,H,T,T)
    q, scales = _quantize(attn)
    imgs_u8 = np.asarray(imgs)
    if imgs_u8.max() <= 1.5:
        imgs_u8 = imgs_u8 * 255.0
    imgs_u8 = np.clip(imgs_u8, 0, 255).astype(np.uint8)
    return {
        "name": os.path.basename(os.path.normpath(ckpt)),
        "shape": list(attn.shape),
        "attn_b64": base64.b64encode(q.tobytes()).decode(),
        "scales": [round(float(v), 6) for v in scales],
        "imgs_b64": base64.b64encode(imgs_u8.tobytes()).decode(),
        "img_hw": list(imgs_u8.shape[1:3]),
        "preds": [int(p) for p in np.argmax(logits, axis=-1)],
        "patch": int(cfg.patch),
        "is_cls": bool(cfg.is_cls_token),
    }


_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>Attention dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;display:flex;background:#fafafa}
 #sidebar{width:270px;min-width:270px;padding:14px;background:#f0f2f6;height:100vh;
          overflow-y:auto;box-sizing:border-box}
 #main{flex:1;padding:14px;height:100vh;overflow-y:auto;box-sizing:border-box}
 h1{font-size:1.05em;margin:0 0 10px} h2{font-size:1em;margin:14px 0 6px}
 .ctl{margin:8px 0} label{font-size:.85em;display:block;margin-bottom:2px}
 select,input[type=number]{width:100%;box-sizing:border-box}
 .cols{display:flex;gap:20px;flex-wrap:wrap}
 .col{flex:1;min-width:320px}
 .grid{display:grid;gap:6px}
 .cell canvas{width:100%;image-rendering:pixelated;border:1px solid #ddd}
 .cell.smooth canvas{image-rendering:auto}
 .cell p{font-size:.72em;margin:2px 0;text-align:center;color:#444}
 #preview{width:100%;image-rendering:pixelated;border:1px solid #ccc}
 details{margin-top:10px;font-size:.9em}
</style></head><body>
<div id="sidebar">
 <h1>Visualizing Attention in Transformers</h1>
 <div class="ctl"><label>Model</label><select id="model"></select></div>
 <div class="ctl"><label>Image (1..B)</label>
   <input type="number" id="img" min="1" value="1"></div>
 <div class="ctl"><label>Token</label><select id="token">
   <option value="all">All Tokens</option>
   <option value="cls">&lt;CLS&gt; Token</option>
   <option value="choose">choose a token</option></select>
   <input type="number" id="tokidx" min="1" value="1" style="display:none"></div>
 <canvas id="preview" width="64" height="64"></canvas>
 <div class="ctl"><label><input type="checkbox" id="overlay"> Show maps on input image</label></div>
 <div class="ctl"><label><input type="checkbox" id="transpose"> Transpose Attention</label></div>
 <div class="ctl"><label>Heads</label><select id="heads">
   <option value="all">Show all heads</option>
   <option value="avg">Average over heads</option>
   <option value="choose">choose a head</option></select>
   <input type="number" id="headidx" min="1" value="1" style="display:none"></div>
 <details><summary>Advanced Options</summary>
   <div class="ctl"><label>Color Map</label><select id="cmap">
     <option>Jet</option><option>Hot</option><option>Cool</option>
     <option>Bone</option><option>Rainbow</option><option>Viridis</option></select></div>
   <div class="ctl"><label>Resize Interpolation</label><select id="interp">
     <option value="linear">Linear</option><option value="nearest">Nearest</option></select></div>
   <div class="ctl"><label>Max maps per row</label>
     <input type="number" id="maxcols" min="1" max="10" value="5"></div>
   <div class="ctl"><label>Mask Intensity <span id="alphav">0.4</span></label>
     <input type="range" id="alpha" min="0" max="1" step="0.05" value="0.4"
            style="width:100%"></div>
 </details>
 <p id="meta" style="font-size:.8em;color:#555"></p>
</div>
<div id="main"><div class="cols">
 <div class="col"><h2>Joint Attentions</h2><div id="joint" class="grid"></div></div>
 <div class="col"><h2>Attention Maps</h2><div id="maps" class="grid"></div></div>
</div></div>
<script>
const MODELS = window.__VIT_MODELS || [];
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const CMAPS={
 Jet:t=>[255*Math.min(Math.max(1.5-Math.abs(4*t-3),0),1),
         255*Math.min(Math.max(1.5-Math.abs(4*t-2),0),1),
         255*Math.min(Math.max(1.5-Math.abs(4*t-1),0),1)],
 Hot:t=>[255*Math.min(3*t,1),255*Math.min(Math.max(3*t-1,0),1),
         255*Math.min(Math.max(3*t-2,0),1)],
 Cool:t=>[255*t,255*(1-t),255],
 Bone:t=>[255*t*0.95,255*(t*0.85+0.1*t),255*Math.min(t*1.15,1)],
 Rainbow:t=>{const h=(1-t)*240/360;const f=(n,k=(n+h*6)%6)=>
   255*(1-Math.max(Math.min(k,4-k,1),0));return[f(5),f(3),f(1)];},
 Viridis:t=>[255*(0.267+t*(0.993-0.267)*t),255*(0.004+t*0.902),
             255*(0.329+t*(0.144-0.329))],
};
const S={model:0,img:0,token:null,transpose:false,heads:"all",head:0,
         overlay:false,cmap:"Jet",interp:"linear",maxcols:5,alpha:0.4};
let D=null; // decoded current model {attn:Float32Array,L,B,H,T,imgs,patch,isCls}
const DECODED={};
function decode(mi){
  if(DECODED[mi]){D=DECODED[mi];return;}
  const m=MODELS[mi];const [L,B,H,T]=m.shape;const q=b64u8(m.attn_b64);
  const n=L*B*H*T*T;const a=new Float32Array(n);const TT=T*T;
  for(let map=0;map<L*B*H;map++){const lo=m.scales[2*map],hi=m.scales[2*map+1];
    const s=(hi-lo)/255||0;const off=map*TT;
    for(let i=0;i<TT;i++)a[off+i]=lo+q[off+i]*s;}
  D=DECODED[mi]={attn:a,L,B,H,T,imgs:b64u8(m.imgs_b64),hw:m.img_hw,preds:m.preds,
     patch:m.patch,isCls:m.is_cls,name:m.name};
}
// current view maps: returns {maps:[{label,data:Float32Array,T}],grid}
function headTransformed(){ // (L,H',T,T) for selected image, after transforms
  const {attn,L,B,H,T}=D;const b=S.img;const TT=T*T;const out=[];
  let Hs= S.heads==="all"?[...Array(H).keys()]: S.heads==="choose"?[Math.min(S.head,H-1)]:null;
  for(let l=0;l<L;l++){
    const heads=[];
    if(Hs===null){ // average
      const m=new Float32Array(TT);
      for(let h=0;h<H;h++){const off=((l*B+b)*H+h)*TT;
        for(let i=0;i<TT;i++)m[i]+=attn[off+i]/H;}
      heads.push({h:"avg",m});
    }else for(const h of Hs){const off=((l*B+b)*H+h)*TT;
      heads.push({h,m:attn.subarray(off,off+TT).slice()});}
    if(S.transpose)for(const e of heads){const m=e.m;const t=new Float32Array(TT);
      for(let i=0;i<T;i++)for(let j=0;j<T;j++)t[j*T+i]=m[i*T+j];e.m=t;}
    out.push(heads);
  }
  return out;
}
function rollout(layers){ // mirrors get_joint_attentions (attention/utils.py:70-105)
  const T=D.T,TT=T*T;const Hn=layers[0].length;const joint=[];
  const norm=m=>{const a=new Float32Array(TT);
    for(let i=0;i<T;i++){let s=0;for(let j=0;j<T;j++){const v=m[i*T+j]+(i===j?1:0);a[i*T+j]=v;s+=v;}
      for(let j=0;j<T;j++)a[i*T+j]/=s;}return a;};
  for(let h=0;h<Hn;h++){
    let prev=null;const per=[];
    for(let l=0;l<layers.length;l++){
      const aug=norm(layers[l][h].m);
      let j;
      if(!prev)j=aug;else{j=new Float32Array(TT);
        for(let r=0;r<T;r++)for(let k=0;k<T;k++){let s=0;
          for(let c=0;c<T;c++)s+=aug[r*T+c]*prev[c*T+k];j[r*T+k]=s;}}
      per.push(j);prev=j;}
    joint.push(per);}
  return joint; // [head][layer] -> Float32Array(TT)
}
function drawMap(canvas,data,w,h,scale){
  const cm=CMAPS[S.cmap];canvas.width=w;canvas.height=h;
  let lo=Infinity,hi=-Infinity;for(const v of data){if(v<lo)lo=v;if(v>hi)hi=v;}
  const s=hi>lo?1/(hi-lo):0;
  const ctx=canvas.getContext("2d");const im=ctx.createImageData(w,h);
  for(let i=0;i<w*h;i++){const[r,g,b]=cm((data[i]-lo)*s);
    im.data[4*i]=r;im.data[4*i+1]=g;im.data[4*i+2]=b;im.data[4*i+3]=255;}
  ctx.putImageData(im,0,0);
}
function drawOverlay(canvas,row,P){ // row: P*P patch attention over input image
  const[H,W]=D.hw;canvas.width=W;canvas.height=H;
  const ctx=canvas.getContext("2d");const im=ctx.createImageData(W,H);
  const img=D.imgs,b=S.img,base=b*H*W*3;const cm=CMAPS[S.cmap];
  let lo=Infinity,hi=-Infinity;for(const v of row){if(v<lo)lo=v;if(v>hi)hi=v;}
  const s=hi>lo?1/(hi-lo):0;const a=S.alpha;
  const ph=H/P,pw=W/P;
  for(let y=0;y<H;y++)for(let x=0;x<W;x++){
    let t;
    if(S.interp==="nearest"){t=(row[Math.min(Math.floor(y/ph),P-1)*P+
      Math.min(Math.floor(x/pw),P-1)]-lo)*s;}
    else{ // bilinear over patch centers
      const fy=Math.min(Math.max(y/ph-0.5,0),P-1),fx=Math.min(Math.max(x/pw-0.5,0),P-1);
      const y0=Math.floor(fy),x0=Math.floor(fx),y1=Math.min(y0+1,P-1),x1=Math.min(x0+1,P-1);
      const wy=fy-y0,wx=fx-x0;
      const v=(1-wy)*((1-wx)*row[y0*P+x0]+wx*row[y0*P+x1])
             +wy*((1-wx)*row[y1*P+x0]+wx*row[y1*P+x1]);
      t=(v-lo)*s;}
    const[r,g,bl]=cm(t);const i=y*W+x;const src=base+i*3;
    im.data[4*i]  =(1-a)*img[src]  +a*r;
    im.data[4*i+1]=(1-a)*img[src+1]+a*g;
    im.data[4*i+2]=(1-a)*img[src+2]+a*bl;
    im.data[4*i+3]=255;}
  ctx.putImageData(im,0,0);
}
function drawPreview(){
  const cv=document.getElementById("preview");const[H,W]=D.hw;
  cv.width=W;cv.height=H;const ctx=cv.getContext("2d");
  const im=ctx.createImageData(W,H);const base=S.img*H*W*3;
  for(let i=0;i<H*W;i++){im.data[4*i]=D.imgs[base+i*3];
    im.data[4*i+1]=D.imgs[base+i*3+1];im.data[4*i+2]=D.imgs[base+i*3+2];
    im.data[4*i+3]=255;}
  ctx.putImageData(im,0,0);
  const P=D.patch;ctx.strokeStyle="rgba(255,255,255,.8)";ctx.lineWidth=0.5;
  for(let i=1;i<P;i++){ctx.beginPath();ctx.moveTo(i*W/P,0);ctx.lineTo(i*W/P,H);ctx.stroke();
    ctx.beginPath();ctx.moveTo(0,i*H/P);ctx.lineTo(W,i*H/P);ctx.stroke();}
  if(S.token!==null&&!(D.isCls&&S.token===0)){
    const t=D.isCls?S.token-1:S.token;const r=Math.floor(t/P),c=t%P;
    ctx.strokeStyle="red";ctx.lineWidth=2;
    ctx.strokeRect(c*W/P,r*H/P,W/P,H/P);}
}
function render(){
  decode(S.model);
  // clamp selections when switching to a smaller model
  S.img=Math.min(S.img,D.B-1);
  if(S.token!==null)S.token=Math.min(S.token,D.T-1);
  S.head=Math.min(S.head,D.H-1);
  document.getElementById("img").max=D.B;
  document.getElementById("tokidx").max=D.T-1;
  document.getElementById("headidx").max=D.H;
  document.getElementById("meta").textContent=
    `${D.name} | L=${D.L} H=${D.H} T=${D.T} | prediction: class ${D.preds[S.img]}`;
  drawPreview();
  const layers=headTransformed();
  const joints=rollout(layers);
  const cols=Math.min(S.maxcols,layers[0].length);
  for(const[divId,source]of[["joint",(l,h)=>joints[h][l]],
                            ["maps",(l,h)=>layers[l][h].m]]){
    const div=document.getElementById(divId);div.innerHTML="";
    div.style.gridTemplateColumns=`repeat(${cols},1fr)`;
    for(let l=0;l<layers.length;l++)for(let h=0;h<layers[l].length;h++){
      const cell=document.createElement("div");cell.className="cell";
      if(S.interp==="linear")cell.classList.add("smooth");
      const cv=document.createElement("canvas");
      const p=document.createElement("p");
      const hl=layers[l][h].h;
      p.textContent=`layer ${l}`+(hl==="avg"?" (head avg)":` head ${hl}`);
      const data=source(l,h);const T=D.T,P=D.patch;
      if(S.token===null){drawMap(cv,data,T,T);}
      else{
        let row=data.subarray(S.token*T,(S.token+1)*T);
        if(D.isCls)row=row.subarray(1);
        if(S.overlay)drawOverlay(cv,row,P);
        else drawMap(cv,row,P,P);
      }
      cell.appendChild(cv);cell.appendChild(p);div.appendChild(cell);
    }
  }
}
function rolloutSelfTest(){
  // Executes on EVERY page load: the JS rollout above is checked against an
  // expected tensor computed at generation time by the Python reference
  // implementation (analysis/attention_maps.get_joint_attentions).  A
  // mismatch paints a red banner — the formula cannot silently drift.
  const tv=window.__ROLLOUT_TEST;if(!tv)return;
  const T=tv.T,TT=T*T;const saveD=D;D={T:T};
  const layers=tv.input.map(lay=>[{h:0,m:Float32Array.from(lay)}]);
  let maxdiff=Infinity;
  try{
    const got=rollout(layers); // [head=0][layer] -> Float32Array(TT)
    maxdiff=0;
    for(let l=0;l<tv.expected.length;l++)
      for(let i=0;i<TT;i++)
        maxdiff=Math.max(maxdiff,Math.abs(got[0][l][i]-tv.expected[l][i]));
  }finally{D=saveD;}
  window.__ROLLOUT_SELFTEST=maxdiff<1e-5?"pass":"fail:maxdiff="+maxdiff;
  if(!(maxdiff<1e-5)){const b=document.createElement("div");
    b.style.cssText="background:#c00;color:#fff;padding:6px;font-size:.9em;position:fixed;top:0;left:0;right:0;z-index:9";
    b.textContent="rollout self-test FAILED ("+window.__ROLLOUT_SELFTEST+")";
    document.body.prepend(b);}
}
function init(){
  rolloutSelfTest();
  const ms=document.getElementById("model");
  MODELS.forEach((m,i)=>{const o=document.createElement("option");
    o.value=i;o.textContent=m.name;ms.appendChild(o);});
  const on=(id,ev,fn)=>document.getElementById(id).addEventListener(ev,fn);
  on("model","change",e=>{S.model=+e.target.value;render();});
  on("img","change",e=>{S.img=Math.min(Math.max(0,+e.target.value-1),D.B-1);render();});
  const toksel=()=>{const v=document.getElementById("token").value;
    const ti=document.getElementById("tokidx");
    ti.style.display=v==="choose"?"block":"none";
    S.token=v==="all"?null:v==="cls"?0:+ti.value;render();};
  on("token","change",toksel);on("tokidx","change",toksel);
  const headsel=()=>{const v=document.getElementById("heads").value;
    const hi=document.getElementById("headidx");
    hi.style.display=v==="choose"?"block":"none";
    S.heads=v;S.head=+hi.value-1;render();};
  on("heads","change",headsel);on("headidx","change",headsel);
  on("transpose","change",e=>{S.transpose=e.target.checked;render();});
  on("overlay","change",e=>{S.overlay=e.target.checked;render();});
  on("cmap","change",e=>{S.cmap=e.target.value;render();});
  on("interp","change",e=>{S.interp=e.target.value;render();});
  on("maxcols","change",e=>{S.maxcols=Math.max(1,+e.target.value);render();});
  on("alpha","input",e=>{S.alpha=+e.target.value;
    document.getElementById("alphav").textContent=e.target.value;render();});
  if(MODELS.length)render();
  else document.getElementById("main").innerHTML="<p>No models embedded.</p>";
}
init();
</script></body></html>
"""


def generate_interactive(
    ckpts: list[str], out_dir: str = "report", batch_size: int = 8,
    device="cuda",
) -> str:
    """Write ``index.html`` + one ``data_<i>.js`` per checkpoint.  Returns the
    index path.  The page's dropdowns switch model/image/token/head/colormap
    client-side — the exploration workflow of the reference Streamlit app."""
    os.makedirs(out_dir, exist_ok=True)
    tags = []
    i = 0
    for ckpt in ckpts:
        try:
            payload = model_payload(ckpt, batch_size=batch_size,
                                    device=device)
        except ValueError as e:
            # CNN-family checkpoints have no attention maps to show (the
            # reference app fails on them the same way) — skip, keep going
            print(f"[dashboard] skipping {ckpt}: {type(e).__name__}: {e}")
            continue
        path = os.path.join(out_dir, f"data_{i}.js")
        with open(path, "w") as f:
            f.write(
                "window.__VIT_MODELS=window.__VIT_MODELS||[];"
                f"window.__VIT_MODELS.push({json.dumps(payload)});"
            )
        tags.append(f'<script src="data_{i}.js"></script>')
        i += 1
    test_tag = f"<script>window.__ROLLOUT_TEST={json.dumps(rollout_test_vector())};</script>"
    html = _HTML.replace("<script>", "\n".join(tags + [test_tag]) + "\n<script>", 1)
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(html)
    return index


def rollout_test_vector(L: int = 3, T: int = 4) -> dict:
    """Deterministic input + expected rollout for the page's client-side
    self-test (``rolloutSelfTest``): ``input`` is (L,) lists of T*T
    attention-like values, ``expected`` the reference rollout
    (get_joint_attentions, attention/utils.py:70-105) per layer.  Tested to
    match the Python implementation in tests/test_analysis.py; executed by
    the browser on every page load."""
    from .attention_maps import get_joint_attentions

    rng = np.random.default_rng(42)
    # round the INPUT first so the expected rollout is computed from exactly
    # the values the JS will see after JSON serialization
    attn = np.round(rng.random((L, 1, 1, T, T)), 6).astype(np.float32)
    joint = get_joint_attentions(attn)  # (L,1,1,T,T)
    return {
        "T": T,
        "input": [[round(float(v), 6) for v in attn[l, 0, 0].reshape(-1)]
                  for l in range(L)],
        "expected": [[round(float(v), 6) for v in joint[l, 0, 0].reshape(-1)]
                     for l in range(L)],
    }
