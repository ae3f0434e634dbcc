"""Thin interactive browser viewer over the port's Session.

A copy of viamd_tpu/app/viewer.py: the same page, `/render` and `/api/*`
endpoints, over `viamd_tpu_torch.app.session.Session` on its device. A
frame is copied to the host only to be encoded; PNGs are written by
`app.export.encode_png` (no imaging library).

Closes the interactive-loop gap with the reference application
(VIAMD src/main.cpp:362-1202: vsync'd main loop with trackball
camera, picking, playback — plus the script-editor, timeline and
distribution windows, main.cpp:4248/4875 and the selection-query input):
a stdlib http.server serves one HTML page whose canvas shows
Session.render frames; mouse drags orbit the trackball camera, wheel
zooms (dolly), clicks pick + select, and a playback slider scrubs
trajectory frames. A side panel edits the analysis script (located
compile errors inline), evaluates it, plots property time series /
distributions (tiny numpy rasterizer — no plotting dependency), and runs
selection-language queries. It also manages N representations with
per-rep filter / type / color mapping / enable (the representations
window, main.cpp:3617) and composites a volume property of the last
evaluation in-scene (the density-volume window, density_volume.cpp:761)
via Session.render(volume=...). No extra dependencies — PNG encoding via the
port's own encoder, transport is plain fetch() polling driven by
input events (the render itself is the rate limiter, as in the reference
where heavy work is async to the UI).

Usage:
    viamd-tpu-torch view file.pdb [traj.xtc] --port 8844
or  ViewerServer(session).serve()   (serve(blocking=False) + close())
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from viamd_tpu_torch.app.export import encode_png

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>viamd-tpu</title><style>
body{margin:0;background:#15171a;color:#ccc;font:13px sans-serif;
     display:flex;flex-direction:column;height:100vh}
#bar{padding:6px 10px;display:flex;gap:10px;align-items:center}
#main{flex:1;min-height:0;display:flex}
#cv{flex:1;min-height:0;min-width:0;cursor:grab;object-fit:contain}
#side{width:340px;display:flex;flex-direction:column;gap:6px;
      padding:6px;background:#1b1d21;overflow-y:auto}
#script{height:140px;background:#101214;color:#cdc;border:1px solid #333;
        font:12px monospace;resize:vertical}
#err{color:#e66;font:11px monospace;white-space:pre-wrap}
#selinfo{color:#8a8;font:11px monospace}
#plot{width:100%;background:#101214;border:1px solid #333}
input[type=range]{flex:1}
select,button,input[type=text]{background:#26292e;color:#ccc;
  border:1px solid #444}
#info{min-width:220px;text-align:right;color:#8a8}
.row{display:flex;gap:6px;align-items:center}
</style></head><body>
<div id="bar">
 <b>viamd-tpu</b>
 <select id="rep"><option>spacefill</option><option>licorice</option>
   <option>ballstick</option><option>cartoon</option></select>
 <button id="play">▶</button>
 <input type="range" id="frame" min="0" max="0" value="0">
 <span id="fno">0</span>
 <span id="info"></span>
</div>
<div id="main">
<img id="cv" draggable="false">
<div id="side">
 <b>Script</b>
 <textarea id="script" spellcheck="false"></textarea>
 <div class="row">
  <button id="apply">Apply</button>
  <button id="evalbtn">Evaluate</button>
  <span id="evst"></span>
 </div>
 <div id="err"></div>
 <b>Properties</b>
 <div class="row">
  <select id="prop"></select>
  <select id="kind"><option>temporal</option><option>histogram</option>
  </select>
 </div>
 <img id="plot">
 <b>Selection query</b>
 <div class="row">
  <input type="text" id="selq" placeholder="protein and within(5, resname('ALA'))"
   style="flex:1">
  <button id="selgo">Select</button>
 </div>
 <div id="selinfo"></div>
 <div class="row"><b style="flex:1">Representations</b>
  <button id="repadd">+ Add</button></div>
 <div id="reps"></div>
 <b>Volume</b>
 <div class="row">
  <select id="vol" style="flex:1"><option value="">(none)</option></select>
  <span id="volst"></span>
 </div>
 <div id="qmpanel" style="display:none">
  <b>QM spectra</b>
  <div class="row">
   <select id="qmsel" style="flex:1"></select>
  </div>
  <img id="qmplot" style="width:100%"/>
 </div>
</div>
</div>
<script>
const cv=document.getElementById('cv'),info=document.getElementById('info');
const frame=document.getElementById('frame'),fno=document.getElementById('fno');
let busy=false,dirty=true,drag=null,playing=false;
let lastUrl=null;
async function refresh(){
  if(busy){dirty=true;return;} busy=true;dirty=false;
  const w=Math.min(1024,cv.clientWidth||640),h=Math.min(768,cv.clientHeight||480);
  const r=await fetch(`/render?w=${w}&h=${h}`);
  const b=await r.blob();
  if(lastUrl)URL.revokeObjectURL(lastUrl);
  lastUrl=URL.createObjectURL(b); cv.src=lastUrl;
  busy=false; if(dirty)refresh();
}
async function post(u,d){await fetch(u,{method:'POST',body:JSON.stringify(d)});refresh();}
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('mouseup',async e=>{
  if(drag&&Math.abs(e.clientX-drag[0])<3&&Math.abs(e.clientY-drag[1])<3){
    // map the click through object-fit:contain onto the image pixels and
    // pick at the SAME resolution the frame was rendered at
    const rc=cv.getBoundingClientRect();
    const iw=cv.naturalWidth||1,ih=cv.naturalHeight||1;
    const sc=Math.min(rc.width/iw,rc.height/ih);
    const ox=(rc.width-iw*sc)/2,oy=(rc.height-ih*sc)/2;
    const fx=(e.clientX-rc.left-ox)/(iw*sc),fy=(e.clientY-rc.top-oy)/(ih*sc);
    drag=null;
    if(fx<0||fx>1||fy<0||fy>1)return;
    const res=await fetch('/api/pick',{method:'POST',body:JSON.stringify(
      {x:fx,y:fy,w:iw,h:ih,shift:e.shiftKey})});
    info.textContent=(await res.json()).label||''; refresh();
  }
  drag=null;});
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=(e.clientX-drag[0])/cv.clientWidth,dy=(e.clientY-drag[1])/cv.clientHeight;
  if(Math.abs(dx)+Math.abs(dy)<0.002)return;
  drag=[e.clientX,e.clientY]; post('/api/orbit',{dx:dx,dy:dy});});
cv.addEventListener('wheel',e=>{e.preventDefault();
  post('/api/zoom',{d:Math.sign(e.deltaY)});},{passive:false});
frame.addEventListener('input',()=>{fno.textContent=frame.value;
  post('/api/frame',{f:+frame.value});});
document.getElementById('rep').addEventListener('change',e=>{
  post('/api/rep',{type:e.target.value});});
document.getElementById('play').addEventListener('click',async e=>{
  playing=!playing;e.target.textContent=playing?'⏸':'▶';
  while(playing){
    let f=(+frame.value+1)%(+frame.max+1);
    frame.value=f;fno.textContent=f;
    await fetch('/api/frame',{method:'POST',body:JSON.stringify({f:f})});
    await refresh();
    await new Promise(r=>setTimeout(r,30));
  }});
// --- side panel: script editor / eval / plots / selection queries ---
const scriptTa=document.getElementById('script'),err=document.getElementById('err');
const propSel=document.getElementById('prop'),kindSel=document.getElementById('kind');
const plot=document.getElementById('plot'),evst=document.getElementById('evst');
async function setProps(names){
  propSel.innerHTML='';
  for(const n of names){const o=document.createElement('option');
    o.textContent=n;propSel.appendChild(o);}
  if(names.length)showPlot();
}
async function showPlot(){
  if(!propSel.value)return;
  plot.src=`/api/plot?prop=${encodeURIComponent(propSel.value)}`+
           `&kind=${kindSel.value}&t=${Date.now()}`;
}
document.getElementById('apply').addEventListener('click',async()=>{
  const r=await fetch('/api/script',{method:'POST',
    body:JSON.stringify({text:scriptTa.value})});
  const d=await r.json();
  err.textContent=(d.errors||[]).join('\\n'); refresh();
});
document.getElementById('evalbtn').addEventListener('click',async()=>{
  evst.textContent='…';
  const r=await fetch('/api/eval',{method:'POST',body:'{}'});
  const d=await r.json();
  evst.textContent=d.error?'error':`${d.n_frames||0} frames`;
  err.textContent=d.error||err.textContent;
  setProps(d.properties||[]);
  setVols(d.volume_props||[],volSel.value);
});
propSel.addEventListener('change',showPlot);
kindSel.addEventListener('change',showPlot);
// --- representation manager (N reps: filter / type / color / enable) ---
const repsDiv=document.getElementById('reps');
const REP_TYPES=['spacefill','licorice','ballstick','tube','ribbons','cartoon'];
const REP_COLORS=['cpk','atom_index','residue_index','residue_name','chain',
                  'secondary_structure','property','uniform'];
function mkSel(opts,cur){const s=document.createElement('select');
  for(const o of opts){const e=document.createElement('option');
    e.textContent=o;if(o===cur)e.selected=true;s.appendChild(e);}return s;}
async function repPost(u,d){const r=await fetch(u,{method:'POST',
  body:JSON.stringify(d)});const j=await r.json();
  if(j.reps)drawReps(j.reps);refresh();}
function drawReps(reps){
  repsDiv.innerHTML='';
  reps.forEach((rep,i)=>{
    const row=document.createElement('div');row.className='row';
    row.style.marginBottom='2px';
    const en=document.createElement('input');en.type='checkbox';
    en.checked=rep.enabled;en.title='enabled';
    en.addEventListener('change',()=>repPost('/api/rep_update',
      {index:i,enabled:en.checked}));
    const filt=document.createElement('input');filt.type='text';
    filt.value=rep.filter;filt.style.width='80px';filt.style.flex='1';
    filt.title=rep.error||`${rep.count} atoms`;
    if(rep.error)filt.style.borderColor='#e66';
    filt.addEventListener('change',()=>repPost('/api/rep_update',
      {index:i,filter:filt.value}));
    const ty=mkSel(REP_TYPES,rep.type);
    ty.addEventListener('change',()=>repPost('/api/rep_update',
      {index:i,type:ty.value}));
    const co=mkSel(REP_COLORS,rep.color_mapping);
    co.addEventListener('change',()=>repPost('/api/rep_update',
      {index:i,color_mapping:co.value}));
    const del=document.createElement('button');del.textContent='×';
    del.addEventListener('click',()=>repPost('/api/rep_del',{index:i}));
    for(const e of [en,filt,ty,co,del])row.appendChild(e);
    repsDiv.appendChild(row);
  });
}
document.getElementById('repadd').addEventListener('click',
  ()=>repPost('/api/rep_add',{}));
// --- QM spectra panel (the veloxchem spectra windows as plots) ---
const qmPanel=document.getElementById('qmpanel'),
      qmSel=document.getElementById('qmsel'),
      qmPlot=document.getElementById('qmplot');
function setQm(kinds){
  if(!kinds||!kinds.length){qmPanel.style.display='none';return;}
  qmPanel.style.display='';
  qmSel.innerHTML='';
  for(const k of kinds){const o=document.createElement('option');
    o.value=k;o.textContent=k;qmSel.appendChild(o);}
  showQm();
}
function showQm(){
  if(!qmSel.value)return;
  qmPlot.src=`/api/qm_plot?kind=${encodeURIComponent(qmSel.value)}`+
             `&t=${Date.now()}`;
}
qmSel.addEventListener('change',showQm);
// --- volume panel: composite a volume property in-scene ---
const volSel=document.getElementById('vol'),volst=document.getElementById('volst');
function setVols(props,cur){
  volSel.innerHTML='<option value="">(none)</option>';
  for(const p of props){const o=document.createElement('option');
    o.textContent=p;o.value=p;if(p===cur)o.selected=true;
    volSel.appendChild(o);}
}
volSel.addEventListener('change',async()=>{
  const r=await fetch('/api/volume',{method:'POST',
    body:JSON.stringify({prop:volSel.value||null})});
  const d=await r.json();
  volst.textContent=d.error||'';refresh();});
document.getElementById('selgo').addEventListener('click',async()=>{
  const r=await fetch('/api/select',{method:'POST',
    body:JSON.stringify({query:document.getElementById('selq').value})});
  const d=await r.json();
  document.getElementById('selinfo').textContent=
    d.error?d.error:`${d.count} atoms selected`;
  refresh();
});
(async()=>{const s=await(await fetch('/api/state')).json();
  frame.max=Math.max(0,s.num_frames-1);
  info.textContent=s.title;
  scriptTa.value=s.script||'';
  if(s.properties&&s.properties.length)setProps(s.properties);
  drawReps(s.reps||[]);
  setVols(s.volume_props||[],s.volume);
  setQm(s.qm_spectra||[]);
  refresh();})();
</script></body></html>"""


class ViewerServer:
    """Serve an interactive view of a Session on localhost."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8844):
        self.session = session
        self.host = host
        self.port = port
        self._lock = threading.Lock()  # session (and the TPU) is not
        # reentrant: one render at a time, matching the reference's single
        # GL context
        self.httpd: HTTPServer | None = None
        self.volume_prop: str | None = None  # in-scene volume overlay

    # -- request handling ---------------------------------------------------
    def _render_png(self, w: int, h: int) -> bytes:
        vol = self.volume_prop
        if vol is not None:
            # drop a stale selection (script re-evaluated without it)
            comp = self.session.components["density_volume"]
            if vol not in comp.volume_properties():
                self.volume_prop = vol = None
        with self._lock:
            rgba, _depth, _pick = self.session.render(w, h, volume=vol)
        arr = (np.clip(rgba.cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        return encode_png(arr)

    def _api(self, path: str, data: dict) -> dict:
        from viamd_tpu_torch.render import camera as cam_mod

        s = self.session
        with self._lock:
            if path == "orbit":
                if s.camera is not None:
                    s.camera = cam_mod.trackball_rotate(
                        s.camera, float(data["dx"]), float(data["dy"])
                    )
                return {}
            if path == "zoom":
                if s.camera is not None:
                    import dataclasses

                    c = s.camera
                    off = np.asarray(c.eye, np.float64) - c.center
                    scale = 1.12 if data.get("d", 1) > 0 else 1 / 1.12
                    s.camera = dataclasses.replace(
                        c, eye=np.asarray(c.center + off * scale, np.float32)
                    )
                return {}
            if path == "frame":
                s.set_frame(float(data["f"]))
                return {}
            if path == "rep":
                if s.representations:
                    s.representations[0].type = str(data["type"])
                    s._update_representations()
                return {}
            # -- representation manager (the reference's representations
            # window, main.cpp:3617: N reps, each with filter / color
            # mapping / type / enable) --
            if path == "rep_add":
                s.add_representation(
                    name=str(data.get("name", f"rep{len(s.representations)}"))
                )
                return {"reps": self._reps()}
            if path == "rep_del":
                i = int(data.get("index", -1))
                if 0 <= i < len(s.representations):
                    s.representations.pop(i)
                    from viamd_tpu_torch.app.events import EventType

                    s.events.broadcast(EventType.REPRESENTATION_CHANGED, s)
                return {"reps": self._reps()}
            if path == "rep_update":
                i = int(data.get("index", -1))
                if 0 <= i < len(s.representations):
                    rep = s.representations[i]
                    for k in ("name", "filter", "type", "color_mapping",
                              "prop", "color_map", "dipole_key"):
                        if k in data:
                            setattr(rep, k, str(data[k]))
                    for k in ("map_beg", "map_end", "dipole_scale",
                              "dipole_radius"):
                        if k in data:
                            setattr(rep, k, float(data[k]))
                    if "enabled" in data:
                        rep.enabled = bool(data["enabled"])
                    if "radius_scale" in data:
                        rep.radius_scale = float(data["radius_scale"])
                    if "alpha" in data:
                        rep.alpha = float(data["alpha"])
                    s._update_representations()
                return {"reps": self._reps()}
            if path == "volume":
                # the density-volume panel: pick a volume property of the
                # last eval to composite in-scene (density_volume.cpp:761)
                prop = data.get("prop") or None
                props = self.session.components[
                    "density_volume"
                ].volume_properties()
                if prop is not None and prop not in props:
                    return {"error": f"unknown volume property {prop!r}",
                            "volume_props": props, "volume": None}
                self.volume_prop = prop
                return {"volume_props": props, "volume": prop}
            if path == "script":
                # the script-editor window: recompile + located errors
                s.set_script(str(data.get("text", "")))
                return {"errors": list(s.script_errors)}
            if path == "eval":
                # the evaluate action feeding timeline/distribution plots
                try:
                    res = s.evaluate()
                except Exception as e:  # surface eval errors to the panel
                    return {"error": str(e)}
                props = sorted(res.temporal.keys()) if res else []
                nf = int(getattr(res, "n_frames_done", 0) or 0)
                return {
                    "properties": props,
                    "n_frames": nf,
                    "volume_props": self.session.components[
                        "density_volume"
                    ].volume_properties(),
                }
            if path == "select":
                try:
                    mask = s.select(str(data.get("query", "")))
                except Exception as e:
                    return {"error": str(e), "count": 0}
                return {"count": int(mask.popcount())}
            if path == "pick":
                w = max(64, min(int(data.get("w", 512)), 2048))
                h = max(64, min(int(data.get("h", 384)), 1536))
                x = min(int(float(data["x"]) * w), w - 1)
                y = min(int(float(data["y"]) * h), h - 1)
                idx = s.pick(x, y, w, h)
                label = ""
                if idx >= 0:
                    s.select_at(
                        x, y,
                        level="residue" if data.get("shift") else "atom",
                        width=w, height=h,
                    )
                    sys = s.system
                    rn = sys.res_names[
                        sys.res_name_id[sys.atom_res_idx[idx]]
                    ]
                    an = sys.atom_names[sys.atom_name_id[idx]]
                    label = f"atom {idx} {an} / {rn}"
                return {"atom": int(idx), "label": label}
        return {}

    def _reps(self) -> list[dict]:
        return [
            {
                "name": r.name,
                "filter": r.filter,
                "type": r.type,
                "color_mapping": r.color_mapping,
                "enabled": r.enabled,
                "count": int(r.mask.popcount()) if r.mask is not None else 0,
                "error": r.error,
            }
            for r in self.session.representations
        ]

    def _state(self) -> dict:
        s = self.session
        res = getattr(s, "eval_result", None)
        return {
            "num_frames": s.num_frames,
            "natoms": s.system.natoms if s.system else 0,
            "title": (
                f"{s.system.natoms} atoms, {s.num_frames} frames"
                if s.system
                else "no system"
            ),
            "script": getattr(s, "script_text", "") or "",
            "properties": (
                sorted(res.temporal.keys()) if res is not None else []
            ),
            "reps": self._reps(),
            "volume_props": s.components[
                "density_volume"
            ].volume_properties(),
            "volume": self.volume_prop,
            "qm_spectra": self._qm_spectra_kinds(),
        }

    def _qm_spectra_kinds(self) -> list:
        """Spectra the loaded QM checkpoint supports (the veloxchem
        electronic/vibrational spectroscopy + summary windows,
        veloxchem.cpp:3090-4700)."""
        vlx = self.session.components.get("veloxchem")
        qm = getattr(vlx, "qm", None)
        if qm is None:
            return []
        kinds = []
        if qm.excited is not None or (
            qm.rsp_samples is not None and qm.rsp_samples.sigma is not None
        ):
            kinds.append("absorption")
        if (qm.excited is not None
                and qm.excited.rotatory_strengths is not None) or (
            qm.rsp_samples is not None
            and qm.rsp_samples.delta_epsilons is not None
        ):
            kinds.append("ecd")
        if qm.vib is not None and qm.vib.ir_intensities is not None:
            kinds.append("ir")
        if qm.vib is not None and qm.vib.raman_activities is not None:
            kinds.append("raman")
        if qm.scf_history is not None:
            kinds.append("scf")
        if qm.opt is not None:
            kinds.append("optimization")
        return kinds

    def _qm_plot_png(self, kind: str) -> bytes:
        """Rasterize one QM spectrum/profile as a PNG curve."""
        vlx = self.session.components["veloxchem"]
        if kind == "absorption":
            x, y = vlx.absorption_spectrum_eps()
        elif kind == "ecd":
            x, y = vlx.ecd_spectrum_eps()
        elif kind == "ir":
            x, y = vlx.ir_spectrum()
        elif kind == "raman":
            x, y = vlx.raman_spectrum()
        elif kind == "scf":
            scf = vlx.scf_convergence()
            x = np.arange(1, len(scf["energies"]) + 1)
            y = np.log10(np.maximum(scf["gradient_norms"], 1e-16))
        elif kind == "optimization":
            prof = vlx.optimization_profile()
            x, y = prof["steps"], prof["energies_kj_rel"]
        else:
            raise ValueError(f"unknown QM plot {kind!r}")
        return self._curve_png(np.asarray(y, np.float64))

    def _plot_png(self, prop: str, kind: str) -> bytes:
        """Timeline / distribution plot of an evaluated property — the
        reference's timeline (main.cpp:4248) and distribution
        (main.cpp:4875) windows, rasterized by numpy (no plot library)."""
        res = getattr(self.session, "eval_result", None)
        if res is None:
            raise ValueError("evaluate first")
        W, H = 328, 140
        img = np.full((H, W, 3), 16, np.uint8)
        img[:, :, 2] = 20
        fg = np.array([120, 200, 140], np.uint8)
        if kind == "histogram":
            h, _edges = res.histogram(prop)
            y = np.asarray(h, np.float64).reshape(-1)
            n = y.size
            ym = y.max() if y.size and y.max() > 0 else 1.0
            xs = (np.arange(n) * (W - 1) / max(n - 1, 1)).astype(int)
            for i in range(n):
                x0 = xs[i]
                x1 = xs[i + 1] if i + 1 < n else W - 1
                hh = int((H - 8) * y[i] / ym)
                img[H - 4 - hh:H - 4, x0:max(x1, x0 + 1)] = fg
        else:
            y = np.asarray(res.temporal[prop], np.float64)
            return self._curve_png(y.reshape(y.shape[0], -1).mean(axis=1))
        return encode_png(img)

    def _curve_png(self, y: np.ndarray) -> bytes:
        """Rasterize one curve (shared by the property timeline and the
        QM spectra plots)."""
        W, H = 328, 140
        img = np.full((H, W, 3), 16, np.uint8)
        img[:, :, 2] = 20
        fg = np.array([120, 200, 140], np.uint8)
        y = np.asarray(y, np.float64).reshape(-1)
        n = y.size
        lo, hi = float(np.nanmin(y)), float(np.nanmax(y))
        span = (hi - lo) or 1.0
        px = (np.arange(n) * (W - 9) / max(n - 1, 1)).astype(int) + 4
        py = (H - 5 - (y - lo) / span * (H - 10)).astype(int)
        for i in range(n - 1):
            x0, x1 = px[i], px[i + 1]
            y0, y1 = py[i], py[i + 1]
            steps = max(abs(x1 - x0), abs(y1 - y0), 1)
            xs = np.linspace(x0, x1, steps + 1).astype(int)
            ys = np.linspace(y0, y1, steps + 1).astype(int)
            img[np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)] = fg
        return encode_png(img)

    # -- server -------------------------------------------------------------
    def make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif u.path == "/render":
                    q = parse_qs(u.query)
                    w = int(q.get("w", ["640"])[0])
                    h = int(q.get("h", ["480"])[0])
                    w, h = max(64, min(w, 2048)), max(64, min(h, 1536))
                    try:
                        png = viewer._render_png(w, h)
                        self._send(200, png, "image/png")
                    except Exception as e:  # surface render errors to client
                        self._send(500, str(e).encode(), "text/plain")
                elif u.path == "/api/state":
                    self._send(
                        200, json.dumps(viewer._state()).encode(),
                        "application/json",
                    )
                elif u.path == "/api/qm_plot":
                    q = parse_qs(u.query)
                    try:
                        png = viewer._qm_plot_png(
                            q.get("kind", ["absorption"])[0]
                        )
                        self._send(200, png, "image/png")
                    except Exception as e:
                        self._send(
                            400, json.dumps({"error": str(e)}).encode(),
                            "application/json",
                        )
                elif u.path == "/api/plot":
                    q = parse_qs(u.query)
                    try:
                        png = viewer._plot_png(
                            q.get("prop", [""])[0],
                            q.get("kind", ["temporal"])[0],
                        )
                        self._send(200, png, "image/png")
                    except Exception as e:
                        self._send(500, str(e).encode(), "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    data = json.loads(self.rfile.read(n) or b"{}")
                    out = viewer._api(
                        urlparse(self.path).path.removeprefix("/api/"), data
                    )
                    self._send(
                        200, json.dumps(out).encode(), "application/json"
                    )
                except Exception as e:
                    self._send(500, str(e).encode(), "text/plain")

        return Handler

    def serve(self, blocking: bool = True):
        self.httpd = HTTPServer((self.host, self.port), self.make_handler())
        print(f"viamd-tpu viewer: http://{self.host}:{self.port}/")
        if blocking:
            try:
                self.httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                self.httpd.server_close()
        else:
            t = threading.Thread(
                target=self.httpd.serve_forever, daemon=True
            )
            t.start()
        return self

    def close(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
