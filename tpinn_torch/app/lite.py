"""Dependency-free web UI: the online PDE calculator without dash/plotly
(the port of ``tpinn.app.lite``; training runs on a CUDA card unless
``--device cpu`` is given).

A stdlib ``http.server`` app + vanilla-JS canvas rendering that reproduces
the reference UI's behavior (pinn_app/layout.py + callbacks/*):

- equation input with live grammar validation (now backed by the real
  parser, not a regex),
- dynamic +/- boundary-condition groups (bd_groups.py semantics),
- domain / scl / epsil / sample / network / testing-size / epoch / weight
  inputs with the reference's defaults,
- Start button that launches training in a daemon thread, 1s log polling
  into an autoscrolled <pre>, and 1s figure polling over the same 11
  artifact tabs (result_graph.py tab map),
- per-browser-session UUID keying the artifact directory.

Run:  python -m tpinn_torch.app.lite  [--port 8050] [--data-root data]
                                     [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpinn_torch.app.controller import SessionManager, TrainingRequest
from tpinn_torch.app.figure_data import figure_payload
from tpinn_torch.core import pde

PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpinn_torch — online PDE calculator</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#f4f6f8;color:#1c2733}
header{background:#123;color:#fff;padding:10px 20px;font-size:18px}
main{display:grid;grid-template-columns:390px 1fr;gap:14px;padding:14px}
.card{background:#fff;border-radius:8px;box-shadow:0 1px 3px rgba(0,0,0,.15);padding:14px;margin-bottom:12px}
.card h3{margin:0 0 8px;font-size:14px;text-transform:uppercase;letter-spacing:.05em;color:#567}
label{font-size:12px;color:#456;display:block;margin-top:6px}
input{width:95%;padding:5px;border:1px solid #cdd5dd;border-radius:4px;font-size:13px}
input.invalid{border-color:#d33;background:#fee}
.row{display:flex;gap:8px}.row>div{flex:1}
button{background:#16609e;color:#fff;border:0;border-radius:5px;padding:8px 16px;cursor:pointer;font-size:14px}
button:disabled{background:#9ab;cursor:not-allowed}
button.small{padding:3px 10px;font-size:12px;background:#678}
#log{background:#0b1620;color:#9fe08f;font:11px/1.5 monospace;height:220px;overflow-y:auto;padding:8px;border-radius:6px;white-space:pre-wrap}
.tabs{display:flex;flex-wrap:wrap;gap:4px;margin-bottom:8px}
.tab{padding:5px 10px;border-radius:4px;background:#dde5ec;cursor:pointer;font-size:12px}
.tab.active{background:#16609e;color:#fff}
canvas{background:#fff;border:1px solid #e3e8ee;border-radius:4px;width:100%}
#status{font-size:12px;color:#567;margin-left:10px}
.legend{font-size:11px;color:#456;margin-top:4px}
</style></head><body>
<header>tpinn_torch — PINN PDE calculator (PyTorch/CUDA port)
<span id="status">idle</span></header>
<main>
<div id="left">
 <div class="card"><h3>Problem preset</h3>
  <select id="preset" style="width:99%;padding:5px" onchange="loadPreset()">
   <option value="">— custom —</option>
  </select>
  <div id="recipenote" class="legend"></div>
 </div>
 <div class="card"><h3>Equation (residual = 0, or lhs = rhs)</h3>
  <input id="equation" value="u_rr + 1/r*u_r + 1/r**2*u_tt" spellcheck="false">
  <div class="legend">ops + - * / ** ( ), vars r t x y u, derivatives u_r u_rr u_rt…,
  functions sin cos exp log sqrt tanh, constants pi e, optional “lhs = rhs”.
  A one-coordinate equation is posed on the (x,&nbsp;t) rectangle.</div>
 </div>
 <div class="card"><h3>Boundary conditions <button class="small" onclick="addBC()">+</button>
  <button class="small" onclick="delBC()">−</button></h3><div id="bcs"></div>
 </div>
 <div class="card"><h3>Domain &amp; scales</h3>
  <div class="row"><div><label>x min</label><input id="x_min" value="0.1"></div>
  <div><label>x max</label><input id="x_max" value="1"></div>
  <div><label>y min</label><input id="y_min" value="0"></div>
  <div><label>y max</label><input id="y_max" value="1"></div></div>
  <div class="row"><div><label>SCL (frequency)</label><input id="scl" value="1"></div>
  <div><label>Epsilon (range)</label><input id="epsil" value="1"></div></div>
 </div>
 <div class="card"><h3>Training settings</h3>
  <div class="row"><div><label>n_col</label><input id="n_col" value="3000"></div>
  <div><label>n_bd</label><input id="n_bd" value="1000"></div>
  <div><label>n_add</label><input id="n_add" value="1000"></div></div>
  <div class="row"><div><label>Units/layer</label><input id="depth" value="60"></div>
  <div><label>Hidden layers</label><input id="width" value="6"></div></div>
  <div class="row"><div><label>test nx</label><input id="tx" value="111"></div>
  <div><label>test ny</label><input id="ty" value="111"></div></div>
  <div class="row"><div><label>Adam epochs</label><input id="adam" value="1000"></div>
  <div><label>L-BFGS epochs</label><input id="lbfgs" value="1000"></div></div>
  <div class="row"><div><label>Weight f</label><input id="wf" value="0.05"></div>
  <div><label>Weight df</label><input id="wdf" value="0"></div></div>
  <div class="row"><div><label>LSQ polish</label>
   <select id="lsq_polish"><option>off</option><option>auto</option><option>on</option></select></div>
  <div><label>Defect correction</label>
   <select id="deflation"><option>off</option><option>auto</option><option>full</option></select></div></div>
  <div class="row"><div><label>Unknown coefficients (inverse, e.g. lam=0.5)</label>
   <input id="inverse_params" value="" placeholder="name=init,…" data-optional="1"></div>
  <div><label>Observation oracle</label>
   <select id="oracle"><option value=""></option>%ORACLE_OPTIONS%</select></div></div>
  <div style="margin-top:10px"><button id="start" onclick="start()">Start Training</button></div>
 </div>
 <div class="card"><h3>Training log</h3><div id="log"></div></div>
</div>
<div id="right">
 <div class="card"><h3>Results</h3>
  <div id="tabs"></div>
  <div id="figtitle" class="legend"></div>
  <canvas id="plot" width="900" height="520"></canvas>
 </div>
</div>
</main>
<script>
// two tab rows, as the reference lays them out (6 stage-1 + 5 stage-2 tabs,
// layout.py:493-517) with cross-row exclusivity (result_graph.py:102-118)
const TAB_ROWS = [
 [["colloc_1","Colloc 1"],["solution_1","Solution 1"],["error_1","Error 1"],
  ["loss_1","Loss 1"],["boundary_1","Boundary 1"],["spectrum","Spectrum"]],
 [["colloc_2","Colloc 2"],["solution_2","Solution 2"],["error_2","Error 2"],
  ["loss_2","Loss 2"],["boundary_2","Boundary 2"]]];
const TABS = TAB_ROWS.flat();
let session = sessionStorage.getItem("tpinn-session");
if(!session){session = crypto.randomUUID().replaceAll("-","");
 sessionStorage.setItem("tpinn-session",session);}
let active = "loss_1", nbc = 0;

function addBC(){
 nbc++; const i = nbc;
 const div = document.createElement("div");
 div.className = "row"; div.id = "bc"+i;
 div.innerHTML = `<div><label>x${i} min</label><input id="bd_x${i}_min"></div>
 <div><label>x${i} max</label><input id="bd_x${i}_max"></div>
 <div><label>y${i} min</label><input id="bd_y${i}_min"></div>
 <div><label>y${i} max</label><input id="bd_y${i}_max"></div>
 <div><label>u${i}</label><input id="bd_u${i}"></div>`;
 document.getElementById("bcs").appendChild(div);
}
function delBC(){ if(nbc>1){document.getElementById("bc"+nbc).remove(); nbc--;} }
function seed(i, vals){ for(const [k,v] of Object.entries(vals))
 document.getElementById(k).value = v; }
addBC(); seed(1,{bd_x1_min:"0.1",bd_x1_max:"0.1",bd_y1_min:"0",bd_y1_max:"1",bd_u1:"1"});
addBC(); seed(2,{bd_x2_min:"1",bd_x2_max:"1",bd_y2_min:"0",bd_y2_max:"1",bd_u2:"0"});

(async () => {
 const names = await (await fetch("/api/presets")).json();
 const sel = document.getElementById("preset");
 for(const n of names.presets){
  const o = document.createElement("option"); o.value = n; o.textContent = n;
  sel.appendChild(o);
 }
})();
async function loadPreset(){
 const name = document.getElementById("preset").value;
 if(!name) return;
 const p = await (await fetch("/api/preset?name="+name)).json();
 document.getElementById("equation").value = p.equation;
 for(const k of ["x_min","x_max","y_min","y_max"])
  document.getElementById(k).value = p.domain[k];
 document.getElementById("scl").value = p.scl;
 document.getElementById("epsil").value = p.epsil;
 while(nbc > 1) delBC();
 while(nbc < p.bcs.length) addBC();
 p.bcs.forEach((bc, i) => {
  const j = i+1;
  seed(j, Object.fromEntries([
   ["bd_x"+j+"_min", bc.x_min], ["bd_x"+j+"_max", bc.x_max],
   ["bd_y"+j+"_min", bc.y_min], ["bd_y"+j+"_max", bc.y_max],
   ["bd_u"+j, bc.u]]));
 });
 if(p.train){
  for(const k of ["n_col","n_bd","n_add","depth","width","adam","lbfgs","wf","wdf"])
   document.getElementById(k).value = p.train[k];
  for(const k of ["lsq_polish","deflation"])
   if(p.train[k]) document.getElementById(k).value = p.train[k];
  document.getElementById("recipenote").textContent = p.train.note;
 } else document.getElementById("recipenote").textContent = "";
 eqInput.dispatchEvent(new Event("input"));
}

// ---------- input gating (toggle_all parity, training.py:121-267) ----------
// Start is enabled only when EVERY field is non-empty and the equation is
// valid; while training runs every input is disabled.
let eqValid = true, running = false;
function formReady(){
 if(!eqValid) return false;
 for(const el of document.querySelectorAll("#left input"))
  if(!el.dataset.optional && el.value.trim()==="") return false;
 return true;
}
function gate(){
 for(const el of document.querySelectorAll("#left input, #left select, #left button.small"))
  el.disabled = running;
 document.getElementById("start").disabled = running || !formReady();
}
document.getElementById("left").addEventListener("input", gate);

const eqInput = document.getElementById("equation");
const invInput = document.getElementById("inverse_params");
async function revalidate(){
 const r = await fetch("/api/validate?eq="+encodeURIComponent(eqInput.value)
   +"&params="+encodeURIComponent(invInput.value.trim()));
 const d = await r.json();
 eqValid = d.valid;
 eqInput.classList.toggle("invalid", !d.valid);
 gate();
}
eqInput.addEventListener("input", revalidate);
invInput.addEventListener("input", revalidate);
gate();

async function start(){
 const g = id => document.getElementById(id).value;
 const boundary = {};
 for(let i=1;i<=nbc;i++){
  for(const k of ["x"+i+"_min","x"+i+"_max","y"+i+"_min","y"+i+"_max"])
    boundary["bd_"+k] = parseFloat(g("bd_"+k));
  // u may be a number OR a coordinate expression like sin(pi*x)
  const uraw = g("bd_u"+i).trim();
  const unum = Number(uraw);
  boundary["bd_u"+i] = Number.isFinite(unum) && uraw !== "" ? unum : uraw;
 }
 const req = {
  session: session,
  equation: g("equation"),
  boundary: boundary,
  domain: {x_min:+g("x_min"),x_max:+g("x_max"),y_min:+g("y_min"),y_max:+g("y_max")},
  scl:+g("scl"), epsil:+g("epsil"),
  sample_points:{n_col:+g("n_col"),n_bd:+g("n_bd"),n_add:+g("n_add")},
  network_size:{depth:+g("depth"),width:+g("width")},
  testing_size:{x:+g("tx"),y:+g("ty")},
  epochs:{adam:+g("adam"),lbfgs:+g("lbfgs")},
  equation_weight:{f:+g("wf"),df:+g("wdf")},
  options:{lsq_polish:g("lsq_polish"),deflation:g("deflation")}};
 if(g("inverse_params").trim()){
  req.options.inverse_params = g("inverse_params").trim();
  if(g("oracle")) req.options.oracle = g("oracle");
 }
 const r = await fetch("/api/start",{method:"POST",body:JSON.stringify(req)});
 const d = await r.json();
 if(d.error){ alert(d.error); return; }
 running = true; gate();
}

async function poll(){
 const r = await fetch("/api/status?session="+session);
 const d = await r.json();
 document.getElementById("status").textContent = d.status;
 const log = document.getElementById("log");
 log.textContent = d.log;
 log.scrollTop = log.scrollHeight;   // clientside autoscroll (layout.py:570-582)
 running = (d.status === "running");
 gate();
}
setInterval(poll, 1000);

function tabsInit(){
 const holder = document.getElementById("tabs");
 for(const row of TAB_ROWS){
  const rowEl = document.createElement("div");
  rowEl.className = "tabs";
  for(const [key,label] of row){
   const el = document.createElement("div");
   el.className = "tab"; el.textContent = label; el.id = "tab-"+key;
   el.onclick = () => { active = key; render(); markTabs(); };
   rowEl.appendChild(el);
  }
  holder.appendChild(rowEl);
 }
 markTabs();
}
function markTabs(){ for(const [key] of TABS)
 document.getElementById("tab-"+key).classList.toggle("active", key===active); }
tabsInit();

// ---------- canvas rendering ----------
const JET = t => {  // compact jet colormap
 const r = Math.min(Math.max(1.5-Math.abs(4*t-3),0),1);
 const g = Math.min(Math.max(1.5-Math.abs(4*t-2),0),1);
 const b = Math.min(Math.max(1.5-Math.abs(4*t-1),0),1);
 return [255*r|0,255*g|0,255*b|0];
};
function drawHeat(ctx, box, data, xlim, ylim){
 const {x, y, z} = data;
 let zmin=Infinity, zmax=-Infinity;
 for(const row of z) for(const v of row){ if(v<zmin)zmin=v; if(v>zmax)zmax=v; }
 const span = (zmax-zmin)||1;
 const [bx,by,bw,bh] = box;
 const x0 = xlim ? xlim[0] : x[0], x1 = xlim ? xlim[1] : x[x.length-1];
 const y0 = ylim ? ylim[0] : y[0], y1 = ylim ? ylim[1] : y[y.length-1];
 const img = ctx.createImageData(bw, bh);
 for(let py=0;py<bh;py++){
  const yv = y1 - (py+0.5)/bh*(y1-y0);           // canvas y down → value up
  let j = nearest(y, yv);
  for(let px=0;px<bw;px++){
   const xv = x0 + (px+0.5)/bw*(x1-x0);
   let i = nearest(x, xv);
   const c = JET((z[j][i]-zmin)/span);
   const o = 4*(py*bw+px);
   img.data[o]=c[0]; img.data[o+1]=c[1]; img.data[o+2]=c[2]; img.data[o+3]=255;
  }
 }
 ctx.putImageData(img, bx, by);
 ctx.strokeStyle="#888"; ctx.strokeRect(bx,by,bw,bh);
 axisLabels(ctx, box, [x0,x1], [y0,y1], data.xlabel, data.ylabel);
 colorbar(ctx, bx+bw+8, by, 14, bh, zmin, zmax);
 return [x0,x1,y0,y1];
}
function nearest(arr, v){
 let lo=0, hi=arr.length-1;
 while(hi-lo>1){ const m=(lo+hi)>>1; if(arr[m]<v) lo=m; else hi=m; }
 return (v-arr[lo] < arr[hi]-v) ? lo : hi;
}
function colorbar(ctx,x,y,w,h,zmin,zmax){
 for(let py=0;py<h;py++){
  const c = JET(1-py/h);
  ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`; ctx.fillRect(x,y+py,w,1);
 }
 ctx.fillStyle="#345"; ctx.font="10px monospace";
 ctx.fillText(zmax.toExponential(1), x+w+2, y+8);
 ctx.fillText(zmin.toExponential(1), x+w+2, y+h);
}
function axisLabels(ctx, box, xr, yr, xl, yl){
 const [bx,by,bw,bh]=box;
 ctx.fillStyle="#345"; ctx.font="10px monospace";
 ctx.fillText(xr[0].toPrecision(3), bx, by+bh+12);
 ctx.fillText(xr[1].toPrecision(3), bx+bw-30, by+bh+12);
 ctx.fillText(yr[1].toPrecision(3), bx-34, by+8);
 ctx.fillText(yr[0].toPrecision(3), bx-34, by+bh);
 if(xl) ctx.fillText(xl, bx+bw/2, by+bh+12);
 if(yl) ctx.fillText(yl, bx-34, by+bh/2);
}
function drawLinesLog(ctx, box, series, colors){
 const [bx,by,bw,bh]=box;
 let n=0, vmin=Infinity, vmax=-Infinity;
 for(const s of series){ n=Math.max(n,s.y.length);
  for(const v of s.y) if(v>0){ vmin=Math.min(vmin,v); vmax=Math.max(vmax,v);} }
 if(!isFinite(vmin)){ vmin=1e-8; vmax=1; }
 const lmin=Math.log10(vmin), lmax=Math.log10(vmax)||lmin+1;
 ctx.strokeStyle="#888"; ctx.strokeRect(bx,by,bw,bh);
 series.forEach((s,si)=>{
  ctx.strokeStyle=colors[si%colors.length]; ctx.beginPath();
  s.y.forEach((v,i)=>{
   const px = bx + i/(n-1||1)*bw;
   const py = by + bh - (Math.log10(Math.max(v,vmin))-lmin)/((lmax-lmin)||1)*bh;
   i? ctx.lineTo(px,py) : ctx.moveTo(px,py);
  });
  ctx.stroke();
  ctx.fillStyle=colors[si%colors.length];
  ctx.font="11px sans-serif"; ctx.fillText(s.name, bx+8, by+14+13*si);
 });
 ctx.fillStyle="#345"; ctx.font="10px monospace";
 ctx.fillText("1e"+lmax.toFixed(1), bx-36, by+10);
 ctx.fillText("1e"+lmin.toFixed(1), bx-36, by+bh);
 ctx.fillText("0", bx, by+bh+12); ctx.fillText(String(n), bx+bw-24, by+bh+12);
}
async function render(){
 const r = await fetch(`/api/figure?session=${session}&name=${active}`);
 const d = await r.json();
 const cv = document.getElementById("plot");
 const ctx = cv.getContext("2d");
 ctx.clearRect(0,0,cv.width,cv.height);
 document.getElementById("figtitle").textContent = d.message || "";
 const colors = ["#16609e","#d35f1d","#2d8a4c","#8a2dc0"];
 if(d.type==="missing"){
  ctx.fillStyle="#99a"; ctx.font="18px sans-serif";
  ctx.fillText(d.message, 260, 250); return;
 }
 if(d.type==="heatmap"){ drawHeat(ctx,[60,20,740,440],d,d.xlim,d.ylim); }
 else if(d.type==="heatmap_scatter"){
  const [x0,x1,y0,y1]=drawHeat(ctx,[60,20,740,440],d,null,null);
  ctx.fillStyle="#000";
  for(let i=0;i<d.points_x.length;i++){
   const px=60+(d.points_x[i]-x0)/(x1-x0)*740, py=20+440-(d.points_y[i]-y0)/(y1-y0)*440;
   if(px>=60&&px<=800&&py>=20&&py<=460) ctx.fillRect(px-1,py-1,2,2);
  }
 }
 else if(d.type==="dual_heatmap"){
  drawHeat(ctx,[60,20,340,440],{x:d.x,y:d.y,z:d.z1,xlabel:d.xlabel,ylabel:d.ylabel});
  drawHeat(ctx,[490,20,340,440],{x:d.x,y:d.y,z:d.z2,xlabel:d.xlabel});
  ctx.fillStyle="#345"; ctx.font="12px sans-serif";
  ctx.fillText(d.titles[0],225,16); ctx.fillText(d.titles[1],655,16);
 }
 else if(d.type==="lines_log"){ drawLinesLog(ctx,[60,20,780,440],d.series,colors); }
 else if(d.type==="lines_log_pair"){
  drawLinesLog(ctx,[60,20,360,440],[d.series[0]],colors);
  drawLinesLog(ctx,[480,20,360,440],[d.series[1]],[colors[1]]);
 }
}
setInterval(render, 1000);
render();
</script></body></html>
"""


def _render_page() -> str:
    """PAGE with the oracle <option> list derived from the preset registry
    (tpinn_torch.app.presets.oracle_names)."""
    from tpinn_torch.app.presets import oracle_names

    opts = "".join(f"<option>{n}</option>" for n in oracle_names())
    return PAGE.replace("%ORACLE_OPTIONS%", opts)



def make_handler(manager: SessionManager):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(200, _render_page().encode(),
                           "text/html; charset=utf-8")
            elif url.path == "/api/validate":
                inv_params = ()
                raw = q.get("params", "")
                if raw:
                    from tpinn_torch.core.train import parse_coef_list

                    try:
                        inv_params, _ = parse_coef_list(raw)
                    except ValueError:
                        pass   # bad coef list: validate the bare equation
                ok = pde.validate_equation(q.get("eq", ""),
                                           coords=("r", "t", "x", "y"),
                                           params=inv_params)
                self._json({"valid": bool(ok)})
            elif url.path == "/api/presets":
                from tpinn_torch.app.presets import preset_names

                self._json({"presets": preset_names()})
            elif url.path == "/api/preset":
                from tpinn_torch.app.presets import preset_payload

                try:
                    self._json(preset_payload(q.get("name", "")))
                except KeyError as e:
                    self._json({"error": str(e)}, 404)
            elif url.path == "/api/status":
                self._json(manager.status(q.get("session", "")))
            elif url.path == "/api/figure":
                payload = figure_payload(
                    manager.session_dir(q.get("session", "")), q.get("name", "")
                )
                self._json(payload)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/api/start":
                self._json({"error": "not found"}, 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length))
                session = body.pop("session")
                req = TrainingRequest(**body)
            except (ValueError, TypeError, KeyError) as e:
                self._json({"error": f"bad request: {e}"}, 400)
                return
            err = manager.start(session, req)
            self._json({"error": err} if err else {"ok": True})

    return Handler


def serve(port: int = 8050, data_root: str = "data", wipe: bool = True,
          device="cuda"):
    manager = SessionManager(data_root, device=device)
    if wipe:
        manager.wipe_all()
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(manager))
    print(f"tpinn_torch lite app on http://0.0.0.0:{port} (data root: "
          f"{data_root}, device: {manager.device})")
    server.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(description="tpinn_torch lite web app")
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--data-root", default="data")
    p.add_argument("--no-wipe", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a card")
    args = p.parse_args(argv)
    serve(args.port, args.data_root, wipe=not args.no_wipe,
          device=args.device)


if __name__ == "__main__":
    main()
