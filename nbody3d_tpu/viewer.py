"""Live interactive viewer — the reference's browser experience, served.

The reference is a real-time interactive app: a render loop
(``nbody3d.js:439-514``), dt/G log sliders (``util.js:38-54``),
play/pause (``util.js:56-64``), an orbit/pan/zoom camera driven by mouse
and keys (``camera.js:132-251``), and a live HUD (``index.html:16-48``).
This module reproduces that experience headlessly: a background thread
advances the simulation in scan chunks and renders JPEG frames; a
stdlib HTTP server streams them as MJPEG and accepts control requests.

Endpoints:
  GET  /         — control page (sliders, buttons, key bindings, HUD)
  GET  /stream   — multipart/x-mixed-replace MJPEG of live frames
  GET  /stats    — JSON HUD data (step, rates, energy, camera pose)
  GET  /control  — query-string controls: dt, logdt, G, logG, pause,
                   orbit=dx,dy, pan=dx,dy, zoom=d, fov=d, dollyfov=d
                   (dolly zoom, ``camera.js:112-117``), reset[&ctrl&alt]
                   (modifier partial resets, ``camera.js:119-128``),
                   regenerate (fresh random ICs, ``util.js:69-75``),
                   size=WxH (live resize, ``util.js:91-96``)
  GET  /export.json | /export.npz — download the full simulation state
                   (the reference's export button, ``util.js:265``; the
                   .json form is its exact checkpoint schema)
  POST /import.json | /import.npz — load a checkpoint into the running
                   sim (the reference's import button, ``util.js:217-263``;
                   any N — the sim is rebuilt — and the saved camera pose
                   is restored)

dt and G are traced runtime scalars in the step function, so slider moves
never recompile — exactly the reference's rebuild-free uniform-block
semantics (``nbody3d.js:470``).  Camera keys match ``camera.js:185-251``:
arrows orbit, WASD pan, f/c zoom, space reset — HELD keys apply
continuously per frame tick with the reference's per-frame speed
constants (``nbody3d.js:445-449``, ``camera.js:6-9``), independent of OS
key autorepeat.
"""

from __future__ import annotations

import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!DOCTYPE html>
<html><head><title>nbody3d_tpu live</title><style>
body { margin:0; background:#000; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; white-space:pre; font-size:12px;
       background:rgba(0,0,0,.55); padding:6px; border-radius:4px; }
#panel { position:fixed; top:8px; right:8px; background:rgba(0,0,0,.55);
         padding:8px; border-radius:4px; font-size:12px; }
#panel label { display:block; margin:4px 0; }
img { width:100vw; height:100vh; object-fit:contain; display:block; }
</style></head><body>
<img id="view" src="/stream">
<div id="hud">connecting...</div>
<div id="panel">
  <button id="collapse" style="float:right">&ndash;</button>
  <div id="panelbody">
  <label>dt = 10^<span id="dtv">-4.0</span>
    <input id="dt" type="range" min="-5" max="-3" step="0.01" value="-4"></label>
  <label>G = 10^<span id="Gv">-4.0</span>
    <input id="G" type="range" min="-6" max="0" step="0.01" value="-4"></label>
  <button id="pause">pause</button> <button id="reset">reset cam</button>
  <label>galaxies <input id="ngal" type="number" min="1" max="10" value="2" style="width:3em"></label>
  <label>bodies/galaxy <input id="minb" type="number" min="1000" max="50000" value="20000" style="width:6em">
    &ndash; <input id="maxb" type="number" min="1001" max="50000" value="20000" style="width:6em"></label>
  <button id="regen">regenerate</button>
  <a href="/export.json" download="simulation_export.json">export .json</a>
  <a href="/export.npz" download="simulation_export.npz">.npz</a>
  <label>import <input id="imp" type="file" accept=".json,.npz"></label>
  <div>drag: orbit &middot; right/shift-drag: pan &middot; middle-click: reset<br>
       wheel: zoom &middot; ctrl+wheel: FOV &middot; alt+wheel: dolly zoom<br>
       arrows orbit &middot; WASD pan &middot; f/c zoom (ctrl: FOV, alt: dolly)<br>
       space reset (ctrl: keep zoom+pose &middot; alt: keep pose)</div>
  </div>
</div>
<script>
const send = q => fetch('/control?' + q);
// settings-panel collapse (util.js:77-86)
collapse.onclick = () => {
  const hidden = panelbody.style.display === 'none';
  panelbody.style.display = hidden ? '' : 'none';
  collapse.innerHTML = hidden ? '&ndash;' : '+';
};
dt.oninput = () => { dtv.textContent = dt.value; send('logdt=' + dt.value); };
G.oninput  = () => { Gv.textContent = G.value;  send('logG=' + G.value); };
pause.onclick = () => send('pause=1');
reset.onclick = () => send('reset=1');
let galDirty = false;  // only send panel values the user actually edited
ngal.oninput = minb.oninput = maxb.oninput = () => galDirty = true;
regen.onclick = () => send('regenerate=1' + (galDirty
  ? `&galaxies=${ngal.value}&min_bodies=${minb.value}&max_bodies=${maxb.value}` : ''));
imp.onchange = async () => {
  const f = imp.files[0];
  if (!f) return;
  const ext = f.name.endsWith('.npz') ? '.npz' : '.json';
  await fetch('/import' + ext, {method: 'POST', body: await f.arrayBuffer()});
};
const mods = e => (e.ctrlKey ? '&ctrl=1' : '') + (e.altKey ? '&alt=1' : '');
let drag = null;
view.onmousedown = e => {
  if (e.button === 1) { send('reset=1' + mods(e)); e.preventDefault(); return; }
  drag = [e.clientX, e.clientY, e.button === 2 || e.shiftKey];
  e.preventDefault();
};
view.oncontextmenu = e => e.preventDefault();  // right-drag pans (camera.js:132)
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const [x0, y0, pan] = drag, dx = e.clientX - x0, dy = e.clientY - y0;
  drag = [e.clientX, e.clientY, pan];
  send((pan ? 'pan=' : 'orbit=') + dx + ',' + dy);
};
// wheel: zoom / ctrl = FOV zoom / alt = dolly zoom (camera.js:168-183);
// speeds are the reference's per-deltaY constants (camera.js:3-4)
view.onwheel = e => {
  const q = e.altKey ? 'dollyfov=' + (e.deltaY * 0.0002)
          : e.ctrlKey ? 'fov=' + (e.deltaY * 0.0002)
          : 'zoom=' + (e.deltaY * 0.0005);
  send(q); e.preventDefault();
};
// Held-key continuous camera motion (nbody3d.js:445-449): key state is
// polled every frame tick and applied with the reference's per-frame
// speed constants (camera.js:6-9) — smoothness does not depend on OS
// key autorepeat.
const held = {};
let fcMode = 'zoom';  // modifier captured at the f/c key event (camera.js:227-230)
const CAMKEYS = ['ArrowUp','ArrowDown','ArrowLeft','ArrowRight','w','a','s','d','f','c'];
window.onkeydown = e => {
  if (e.key === ' ') { send('reset=1' + mods(e)); e.preventDefault(); return; }
  const k = e.key.length === 1 ? e.key.toLowerCase() : e.key;
  if (!CAMKEYS.includes(k) || e.target.tagName === 'INPUT') return;
  if (k === 'f' || k === 'c')
    fcMode = e.altKey ? 'dollyfov' : e.ctrlKey ? 'fov' : 'zoom';
  held[k] = true; e.preventDefault();
};
// normalize case on keyup too: pressing Shift mid-hold must not leak a
// stuck lowercase entry ('f' down, Shift, 'F' up)
window.onkeyup = e => {
  held[e.key.length === 1 ? e.key.toLowerCase() : e.key] = false;
};
window.onblur = () => CAMKEYS.forEach(k => held[k] = false);
const KEY_ROT_SPEED = 3, KEY_PAN_SPEED = 5,
      KEY_ZOOM_SPEED = 0.01, KEY_FOV_SPEED = 0.005;
setInterval(() => {  // per-frame key camera (nbody3d.js:445-449)
  // signs match the r3 per-event bindings (ArrowLeft -> orbit dx<0,
  // 'a' -> pan dx<0; parity-audited against camera.js:185-251)
  const q = [];
  const odx = ((held.ArrowRight|0) - (held.ArrowLeft|0)) * KEY_ROT_SPEED;
  const ody = ((held.ArrowDown|0) - (held.ArrowUp|0)) * KEY_ROT_SPEED;
  if (odx || ody) q.push(`orbit=${odx},${ody}`);
  const pdx = ((held.d|0) - (held.a|0)) * KEY_PAN_SPEED;
  const pdy = ((held.s|0) - (held.w|0)) * KEY_PAN_SPEED;
  if (pdx || pdy) q.push(`pan=${pdx},${pdy}`);
  const z = (held.c|0) - (held.f|0);  // f = zoom in (camera.js:219-225)
  if (z) q.push(fcMode === 'zoom' ? `zoom=${z * KEY_ZOOM_SPEED}`
                                  : `${fcMode}=${z * KEY_FOV_SPEED}`);
  if (q.length) send(q.join('&'));
}, 16);
// Live resize: render resolution follows the window (util.js:91-96).
let resizeT = null;
window.onresize = () => {
  clearTimeout(resizeT);
  resizeT = setTimeout(
    () => send(`size=${window.innerWidth}x${window.innerHeight}`), 200);
};
window.onload = () => send(`size=${window.innerWidth}x${window.innerHeight}`);
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  hud.textContent =
    `bodies: ${s.n}\\nstep: ${s.step}\\nfps: ${s.fps.toFixed(1)}` +
    `\\nframe ms: ${s.frame_ms.toFixed(1)}\\nhost ms: ${s.host_ms.toFixed(2)}` +
    `\\ncompute ms: ${s.compute_ms.toFixed(3)}\\nrender ms: ${s.render_ms.toFixed(3)}` +
    `\\nsteps/s: ${s.steps_per_s.toFixed(1)}\\nG-int/s: ${s.gints_per_s.toFixed(2)}` +
    `\\nE: ${s.energy === null ? 'n/a' : s.energy.toExponential(3)}` +
    (s.a === null ? '' : `\\na(t): ${s.a.toFixed(4)}`) +
    `\\ndt: ${s.dt.toExponential(2)}  G: ${s.G.toExponential(2)}` +
    `\\n${s.camera}\\n${s.resolution}${s.paused ? '\\n[paused]' : ''}`;
}, 250);
</script></body></html>"""


class LiveViewer:
    """Owns the sim loop thread + latest-frame buffer + control handling."""

    def __init__(
        self,
        sim,
        *,
        width: int = 960,
        height: int = 720,
        steps_per_frame: int = 20,
        diagnostics_every: int = 0,
        quality: int = 85,
        resolve: str = "auto",
    ):
        from nbody3d_tpu.utils.camera import Camera

        self.sim = sim
        self.width, self.height = width, height
        self.steps_per_frame = max(1, steps_per_frame)
        self.diagnostics_every = diagnostics_every
        self.quality = quality
        self.resolve = resolve  # "device" = on-accelerator rasterization
        self.camera = Camera(target=sim.camera_target)
        self._lock = threading.Lock()  # camera mutations vs render
        # Held while the loop thread advances the (donated) device state;
        # export takes it so it never reads mid-donation arrays.
        self._sim_lock = threading.Lock()
        self._frame = b""
        self._frame_event = threading.Event()
        self._stop = threading.Event()
        self._energy: float | None = None
        self._frames_done = 0
        # HUD timing split (nbody3d.js:434-442,508-514): EMA-filtered
        # frame interval / fps / host overhead / sim-compute time, the
        # reference's filterStrength=10 smoothing.
        self._frame_ms = 10.0
        self._fps = 0.0
        self._host_ms = 0.0
        self._compute_ms = 0.0
        self._last_frame_t: float | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)

    # ------------------------------------------------------------- sim loop
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _loop(self) -> None:
        k = self.steps_per_frame
        filt = 10.0  # reference filterStrength (nbody3d.js:434)
        while not self._stop.is_set():
            t0 = time.perf_counter()
            if self._last_frame_t is not None:
                delta = (t0 - self._last_frame_t) * 1e3
                self._frame_ms += (delta - self._frame_ms) / filt
                self._fps += (1e3 / self._frame_ms - self._fps) / filt
            self._last_frame_t = t0
            if not self.sim.paused:
                # PIPELINED frame: dispatch the frame's device
                # work against the current state, dispatch the next
                # physics chunk (donates that state), then do the
                # frame's host work (fetch/composite/JPEG) WHILE the
                # chunk runs on the device.  The reference couples one
                # step per displayed frame (nbody3d.js:474-505); here
                # the chunk and the frame encode overlap instead.
                with self._sim_lock:
                    from nbody3d_tpu.utils.camera import Camera

                    with self._lock:
                        cam = Camera.from_dict(self.camera.to_dict())
                    handle = self.sim.render_frame_begin(
                        cam, width=self.width, height=self.height,
                        resolve=self.resolve,
                    )
                    token = self.sim.run_async(k)
                    img = self.sim.render_frame_finish(handle)
                    self._publish_jpeg(img)
                    self.sim.wait_chunk(token)
                    if self.diagnostics_every and (
                        self._frames_done % self.diagnostics_every == 0
                    ):
                        self._energy = float(self.sim.diagnostics().total_energy)
                compute = (time.perf_counter() - t0) * 1e3
                self._compute_ms += (compute - self._compute_ms) / filt
            else:
                self._compute_ms = 0.0  # nbody3d.js:496-498 (dt==0 path)
                self._render_frame()  # render-only, like nbody3d.js:474
            # host overhead (the reference's "JS ms"): synchronous frame
            # work minus sim compute and the render itself — JPEG encode,
            # locking, loop bookkeeping.  Pipelined frames fold the
            # render into the chunk wait, so attribute the remainder.
            host = (
                (time.perf_counter() - t0) * 1e3
                - (self._compute_ms if not self.sim.paused else 0.0)
                - (self.sim.last_render_ms or 0.0)
            )
            self._host_ms += (max(host, 0.0) - self._host_ms) / filt
            self._frames_done += 1
            if self.sim.paused:
                time.sleep(0.05)

    def _render_frame(self) -> None:
        from nbody3d_tpu.utils.camera import Camera

        # Snapshot the camera pose under the lock, render OUTSIDE it —
        # a large-N render takes seconds and must not block /control.
        with self._lock:
            cam = Camera.from_dict(self.camera.to_dict())
        img = self.sim.render_frame(
            camera=cam, width=self.width, height=self.height,
            resolve=self.resolve,
        )
        self._publish_jpeg(img)

    def _publish_jpeg(self, img) -> None:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                "the live viewer encodes JPEG frames with Pillow "
                "(pip install pillow)"
            ) from e

        buf = io.BytesIO()
        Image.fromarray(img, mode="RGB").save(buf, "JPEG", quality=self.quality)
        self._frame = buf.getvalue()
        self._frame_event.set()

    # ------------------------------------------------------------- controls
    def control(self, q: dict) -> None:
        sim, cam = self.sim, self.camera
        with self._lock:
            try:
                if "logdt" in q:
                    from nbody3d_tpu.config import log_slider_dt

                    v = log_slider_dt(float(q["logdt"][0]))
                    if sim.paused:
                        sim._old_dt = v  # applied on unpause (util.js:40-44)
                    else:
                        sim.dt = v
                if "dt" in q:
                    sim.dt = float(q["dt"][0])
                if "logG" in q:
                    from nbody3d_tpu.config import log_slider_G

                    sim.G = log_slider_G(float(q["logG"][0]))
                if "G" in q:
                    sim.G = float(q["G"][0])
                self.control_error = None
            except ValueError as err:
                # e.g. live dt/G change rejected on a comoving run
                # (engine._guard_cosmo_param) — surface on the HUD instead
                # of 500'ing the control request.
                self.control_error = str(err)
            if "pause" in q:
                sim.toggle_pause()
            if "orbit" in q:
                dx, dy = (float(v) for v in q["orbit"][0].split(","))
                cam.orbit(dx, dy)
            if "pan" in q:
                dx, dy = (float(v) for v in q["pan"][0].split(","))
                cam.pan(dx, dy)
            if "zoom" in q:
                cam.zoom(float(q["zoom"][0]))
            if "fov" in q:
                cam.adj_fov(float(q["fov"][0]))
            if "dollyfov" in q:
                # dolly zoom: FOV change keeping subject size
                # (camera.js:112-117, alt+wheel / alt+f/c)
                cam.adj_fov_without_zoom(float(q["dollyfov"][0]))
            if "reset" in q:
                # modifier partial resets (camera.js:119-128): ctrl keeps
                # zoom+pose (FOV only), alt keeps pose (FOV + radius)
                cam.reset(ctrl="ctrl" in q, alt="alt" in q)
            if "size" in q:
                # live resize (util.js:91-96): render resolution follows
                # the client window; next frame uses the new matrices.
                try:
                    w, h = (int(v) for v in q["size"][0].split("x"))
                except ValueError:
                    pass
                else:
                    self.width = max(64, min(4096, w))
                    self.height = max(64, min(4096, h))

    def export_state(self, suffix: str) -> bytes:
        """Serialize the current state in the requested checkpoint format
        (the reference's export button, ``util.js:160-208``).  Runs in the
        HTTP thread under the sim lock, so it always observes a chunk
        boundary (never a donated-away buffer)."""
        import os
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "export" + suffix)
            with self._sim_lock:  # not mid-donation (scan donates state)
                self.sim.save(path)
            with open(path, "rb") as f:
                return f.read()

    def import_state(self, data: bytes, suffix: str) -> None:
        """Load an uploaded checkpoint into the running viewer (the
        reference's import button, ``util.js:217-263``).  Unlike the
        reference — which uploads into the existing buffers and silently
        corrupts on an N mismatch — this rebuilds the Simulation, so any
        N works; the saved camera pose is restored (``util.js:247-258``)."""
        import os
        import tempfile

        from nbody3d_tpu.engine import Simulation

        from nbody3d_tpu.utils import checkpoint

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "import" + suffix)
            with open(path, "wb") as f:
                f.write(data)
            with self._sim_lock:
                old = self.sim
                # Keep the running machine config (backend/blocks/strategy);
                # restore the checkpoint's physics params (state, G, dt) —
                # the reference's import semantics (util.js:259-262).
                new = Simulation.load(
                    path, old.config, mesh=old.mesh, platform=old._platform
                )
                saved = checkpoint.peek_config(path)  # None for .json
                if saved is not None:
                    # bypass the cosmology dt/G guard: the saved values ARE
                    # the ones that produced the checkpoint's history
                    new._set_runtime(dt=saved.dt, G=saved.G)
                new._preset = old._preset  # regenerate keeps working
                self.sim = new
        if new.loaded_camera is not None:
            with self._lock:
                self.camera = new.loaded_camera

    def regenerate(self, **settings) -> None:
        """Fresh random ICs from the sim's preset (the reference's
        regenerate button, ``util.js:69-75``); camera re-targets the new
        system's center of mass like a fresh run (``nbody3d.js:126``).
        ``settings`` = the galaxy settings panel (``index.html:68-75``)."""
        from nbody3d_tpu.utils.camera import Camera

        with self._sim_lock:
            self.sim = self.sim.regenerate(**settings)
            target = self.sim.camera_target
        with self._lock:
            self.camera = Camera(target=target)

    def stats(self) -> dict:
        s = self.sim.stats
        return {
            "n": self.sim.n_real,
            "step": self.sim.step_count,
            "steps_per_s": s.steps_per_s if math.isfinite(s.steps_per_s) else 0.0,
            "gints_per_s": s.gints_per_s if math.isfinite(s.gints_per_s) else 0.0,
            "render_ms": self.sim.last_render_ms or 0.0,
            # HUD timing split (index.html:16-34 / nbody3d.js:508-514)
            "fps": self._fps,
            "frame_ms": self._frame_ms,
            "host_ms": self._host_ms,
            "compute_ms": self._compute_ms,
            "energy": self._energy,
            # Comoving runs: live background scale factor (None = static).
            "a": self.sim.scale_factor,
            "dt": self.sim.dt if not self.sim.paused else (self.sim._old_dt or 0.0),
            "G": self.sim.G,
            "paused": self.sim.paused,
            "camera": self.camera.describe(),
            "resolution": f"{self.width}x{self.height}",
            # last rejected control, e.g. a live dt/G change on a comoving
            # run (engine._guard_cosmo_param); None when the last one took.
            "control_error": getattr(self, "control_error", None),
        }

    # --------------------------------------------------------------- server
    def make_server(self, host: str = "127.0.0.1", port: int = 8000):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    self._route()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # noqa: BLE001 — serve 500, keep alive
                    try:
                        body = f"internal error: {e!r}".encode()
                        self.send_response(500)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except OSError:
                        pass

            def _route(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stats":
                    body = json.dumps(viewer.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/control":
                    q = parse_qs(url.query)
                    if q.pop("regenerate", None):
                        # galaxy settings panel values ride the regenerate
                        # request (the reference's main() reads the panel,
                        # index.html:68-75)
                        settings = {
                            name: int(q.pop(key)[0])
                            for key, name in (
                                ("galaxies", "num_galaxies"),
                                ("min_bodies", "min_bodies"),
                                ("max_bodies", "max_bodies"),
                            )
                            if key in q
                        }
                        viewer.regenerate(**settings)  # outside control()'s lock
                    viewer.control(q)
                    self.send_response(204)
                    self.end_headers()
                elif url.path in ("/export.json", "/export.npz"):
                    suffix = ".json" if url.path.endswith(".json") else ".npz"
                    body = viewer.export_state(suffix)
                    ctype = (
                        "application/json"
                        if suffix == ".json"
                        else "application/octet-stream"
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header(
                        "Content-Disposition",
                        f"attachment; filename=simulation_export{suffix}",
                    )
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/frame.jpg":
                    viewer._frame_event.wait(timeout=10)
                    body = viewer._frame
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    try:
                        while not viewer._stop.is_set():
                            viewer._frame_event.wait(timeout=10)
                            viewer._frame_event.clear()
                            frame = viewer._frame
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(frame)}\r\n\r\n".encode()
                            )
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                try:
                    url = urlparse(self.path)
                    if url.path in ("/import.json", "/import.npz"):
                        n = int(self.headers.get("Content-Length", 0))
                        data = self.rfile.read(n)
                        suffix = ".json" if url.path.endswith(".json") else ".npz"
                        viewer.import_state(data, suffix)
                        self.send_response(204)
                        self.end_headers()
                    else:
                        self.send_response(404)
                        self.end_headers()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # noqa: BLE001 — bad upload -> 400
                    try:
                        body = f"import failed: {e!r}".encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except OSError:
                        pass

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        server = self.make_server(host, port)
        self.start()
        print(f"live viewer at http://{host}:{server.server_address[1]}/", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            server.server_close()
