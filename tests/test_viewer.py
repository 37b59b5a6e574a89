"""Live viewer (viewer.py): the served counterpart of the reference's
interactive app — stream, HUD stats, and control semantics
(util.js:38-64 sliders/pause, camera.js:132-251 interaction)."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.engine import Simulation
from nbody3d_tpu.viewer import LiveViewer


@pytest.fixture()
def viewer():
    config = SimConfig(backend="jnp")
    sim = Simulation.from_preset("uniform-sphere", config, n=64)
    v = LiveViewer(sim, width=64, height=48, steps_per_frame=2)
    server = v.make_server("127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    v.start()
    yield v, server.server_address[1]
    v.stop()
    server.shutdown()
    server.server_close()


def _get(port, path, retries=5):
    """GET with retries: under full-suite CPU contention the threaded
    stdlib server occasionally drops a connection mid-handshake."""
    last = None
    for _ in range(retries):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read() if resp.getheader("Content-Length") else b""
            status, headers = resp.status, dict(resp.getheaders())
            conn.close()
            return status, headers, body
        except (http.client.RemoteDisconnected, ConnectionError, OSError) as e:
            last = e
            time.sleep(0.2)
    raise last


def test_page_and_stats(viewer):
    v, port = viewer
    status, headers, body = _get(port, "/")
    assert status == 200 and b"nbody3d_tpu live" in body
    # reference log-slider ranges baked into the page (util.js:38-54)
    assert b'min="-5" max="-3"' in body  # dt
    assert b'min="-6" max="0"' in body  # G

    deadline = time.time() + 20
    while time.time() < deadline:
        status, _, body = _get(port, "/stats")
        s = json.loads(body)
        if s["step"] > 0:
            break
        time.sleep(0.1)
    assert s["step"] > 0
    assert s["n"] == 64
    assert "cam target=" in s["camera"]
    assert s["resolution"] == "64x48"
    assert s["a"] is None  # static space: no background scale factor


def test_frame_endpoint_serves_jpeg(viewer):
    v, port = viewer
    status, headers, body = _get(port, "/frame.jpg")
    assert status == 200
    assert body[:2] == b"\xff\xd8"  # JPEG SOI marker


def test_controls_change_live_params(viewer):
    v, port = viewer
    # dt log-slider: 10^-3.5 (util.js:38-46 semantics)
    _get(port, "/control?logdt=-3.5")
    assert np.isclose(v.sim.dt, 10**-3.5)
    _get(port, "/control?logG=-2")
    assert np.isclose(v.sim.G, 1e-2)
    # pause swaps dt<->0 through oldDt (util.js:56-64).  An in-flight scan
    # chunk may still complete (the reference likewise applies the toggle
    # on the next frame), so wait for the loop to settle first.
    _get(port, "/control?pause=1")
    assert v.sim.paused
    # wait until the loop thread has provably cycled twice in paused mode
    # (frames keep rendering, steps must not advance) — the chunk that was
    # in flight when the toggle landed is allowed to finish first
    frames0 = v._frames_done
    deadline = time.time() + 20
    while time.time() < deadline and v._frames_done < frames0 + 2:
        time.sleep(0.05)
    step0 = v.sim.step_count
    frames1 = v._frames_done
    while time.time() < deadline and v._frames_done < frames1 + 2:
        time.sleep(0.05)
    assert v.sim.step_count == step0  # no stepping while paused
    _get(port, "/control?pause=1")
    assert not v.sim.paused
    assert np.isclose(v.sim.dt, 10**-3.5)  # dt restored

    # camera ops mirror camera.js:81-128
    az0 = v.camera.azimuth
    _get(port, "/control?orbit=10,0")
    assert v.camera.azimuth != az0
    r0 = v.camera.radius
    _get(port, "/control?zoom=0.5")
    assert v.camera.radius > r0
    _get(port, "/control?reset=1")
    assert np.isclose(v.camera.radius, 5.0)  # camera.js default radius


def test_modifier_camera_controls(viewer):
    """The interaction slivers closed in r3: dolly zoom
    (alt+wheel, camera.js:112-117), FOV zoom (ctrl+wheel, :107-110), and
    the ctrl/alt partial resets (:119-128) are reachable via /control."""
    import math

    v, port = viewer
    _get(port, "/control?reset=1")
    fov0, r0 = v.camera.fov, v.camera.radius

    # ctrl+wheel: FOV-only zoom
    _get(port, "/control?fov=0.1")
    assert v.camera.fov > fov0 and np.isclose(v.camera.radius, r0)

    # alt+wheel: dolly zoom — FOV changes, subject size preserved:
    # tan(fov/2) * radius invariant (camera.js:114-116)
    size0 = math.tan(v.camera.fov / 2) * v.camera.radius
    _get(port, "/control?dollyfov=0.15")
    assert v.camera.fov > fov0 + 0.1
    assert np.isclose(math.tan(v.camera.fov / 2) * v.camera.radius, size0)

    # ctrl+reset: FOV restored, radius and pose kept
    _get(port, "/control?zoom=0.5&orbit=20,0")
    r1, az1 = v.camera.radius, v.camera.azimuth
    _get(port, "/control?reset=1&ctrl=1")
    assert np.isclose(v.camera.fov, fov0)
    assert np.isclose(v.camera.radius, r1) and np.isclose(v.camera.azimuth, az1)

    # alt+reset: FOV + radius restored, pose kept
    _get(port, "/control?fov=0.2&zoom=0.5")
    _get(port, "/control?reset=1&alt=1")
    assert np.isclose(v.camera.fov, fov0)
    assert np.isclose(v.camera.radius, 5.0)
    assert np.isclose(v.camera.azimuth, az1)  # pose untouched

    # plain reset: everything back to defaults
    _get(port, "/control?reset=1")
    assert np.isclose(v.camera.azimuth, 0.0)


def test_page_galaxy_panel_matches_reference_bounds(viewer):
    """The served panel clamps to the reference's reachable config space
    (index.html:68-75): bodies/galaxy in [1000, 50000]."""
    _, port = viewer
    _, _, body = _get(port, "/")
    page = body.decode()
    assert 'id="minb" type="number" min="1000" max="50000"' in page
    assert 'id="maxb" type="number" min="1001" max="50000"' in page
    assert 'id="ngal" type="number" min="1" max="10"' in page
    # the new bindings are present in the served script
    for frag in ("dollyfov=", "ctrl=1", "alt=1", "oncontextmenu"):
        assert frag in page, frag


def test_export_endpoints(viewer, tmp_path):
    """The served export buttons (util.js:265): .json is the reference's
    exact checkpoint schema and loads back; .npz is the native format."""
    import json as _json

    v, port = viewer
    status, headers, body = _get(port, "/export.json")
    assert status == 200
    data = _json.loads(body)
    for key in ("bodies", "vel", "accel", "camera", "G"):
        assert key in data
    assert len(data["bodies"]) == 64 * 4

    status, headers, body = _get(port, "/export.npz")
    assert status == 200 and body[:4] == b"PK\x03\x04"  # zip magic
    p = tmp_path / "x.npz"
    p.write_bytes(body)
    from nbody3d_tpu.engine import Simulation

    sim2 = Simulation.load(
        str(p), SimConfig(backend="jnp"),
        platform="cpu",
    )
    assert sim2.n_real == 64


def test_step_count_survives_mid_donation_read():
    """Regression: /stats from the HTTP thread can observe the sim state
    while a scan chunk owns the donated buffers (deleted device arrays).
    step_count must serve the cached chunk-boundary value, not raise."""
    config = SimConfig(backend="jnp")
    sim = Simulation.from_preset("uniform-sphere", config, n=64)
    sim.run(2, chunk=2)
    assert sim.step_count == 2
    sim.state.step.delete()  # what donation does mid-chunk
    assert sim.step_count == 2  # cached, no RuntimeError


def _post(port, path, data, retries=5):
    last = None
    for _ in range(retries):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", path, body=data)
            resp = conn.getresponse()
            body = resp.read()
            status = resp.status
            conn.close()
            return status, body
        except (http.client.RemoteDisconnected, ConnectionError, OSError) as e:
            last = e
            time.sleep(0.2)
    raise last


def test_live_import_and_regenerate(viewer):
    """The reference's import (util.js:217-263) and regenerate
    (util.js:69-75) buttons, served: POST /import.json swaps in the
    uploaded checkpoint (any N, camera restored), /control?regenerate=1
    re-rolls the preset's ICs."""
    v, port = viewer

    # Export the current state, mutate G + camera, re-import: the live sim
    # must pick up the file's G and camera pose (reference semantics).
    _, _, body = _get(port, "/export.json")
    data = json.loads(body)
    data["G"] = "-2.00"  # log-slider string, util.js:200
    data["camera"]["radius"] = 9.0
    status, pbody = _post(port, "/import.json", json.dumps(data).encode())
    assert status == 204, pbody
    assert np.isclose(v.sim.G, 1e-2)
    assert np.isclose(v.camera.radius, 9.0)
    assert v.sim.n_real == 64

    # Import with a DIFFERENT N (the reference would corrupt; we rebuild).
    n4 = len(data["bodies"]) // 4
    for key in ("bodies", "vel", "accel"):
        data[key] = data[key][: (n4 // 2) * 4]
    if "nBodies" in data:
        data["nBodies"] = n4 // 2
    status, pbody = _post(port, "/import.json", json.dumps(data).encode())
    assert status == 204, pbody
    assert v.sim.n_real == 32

    # Garbage upload -> 400, server stays alive.
    assert _post(port, "/import.json", b"{not json")[0] == 400
    assert v.sim.n_real == 32

    # Regenerate: fresh ICs from the preset (uniform-sphere, n=64).
    # Direct state reads need the sim lock (the loop thread donates state
    # into scan chunks; HTTP endpoints take it internally).
    with v._sim_lock:
        p0 = v.sim.arrays()[0].copy()
    status, _, _ = _get(port, "/control?regenerate=1")
    assert status == 204
    assert v.sim.n_real == 64
    with v._sim_lock:
        p1 = v.sim.arrays()[0].copy()
    assert p1.shape != p0.shape or not np.allclose(p1, p0)  # new randomness


def test_regenerate_with_galaxy_settings(viewer):
    """The reference's galaxy settings panel (index.html:68-75) rides the
    regenerate request: main() reads numGalaxies/min/maxBodies at
    generation time, so any preset regenerates as a reference-random run
    when the panel values are supplied."""
    v, port = viewer
    status, _, _ = _get(
        port, "/control?regenerate=1&galaxies=3&min_bodies=30&max_bodies=30"
    )
    assert status == 204
    assert v.sim.n_real == 3 * 31  # 3 galaxies x (30 disk + 1 central)
    assert v.sim._preset[0] == "reference-random"
    # a plain regenerate keeps the new settings (panel state persists)
    _get(port, "/control?regenerate=1")
    assert v.sim.n_real == 3 * 31


def test_held_key_constants_in_page(viewer):
    """The page drives held-key continuous camera motion with the
    reference's per-frame speed constants (camera.js:6-9, polled per
    frame as in nbody3d.js:445-449)."""
    v, port = viewer
    _, _, body = _get(port, "/")
    assert b"KEY_ROT_SPEED = 3" in body
    assert b"KEY_PAN_SPEED = 5" in body
    assert b"KEY_ZOOM_SPEED = 0.01" in body
    assert b"KEY_FOV_SPEED = 0.005" in body
    assert b"window.onkeyup" in body  # state tracked, not per-event nudges
    assert b"window.onresize" in body  # live resize wired (util.js:91-96)
    # Direction parity with the r3 per-event bindings (ArrowLeft ->
    # orbit dx<0, 'a' -> pan dx<0 — camera.js:185-251) and with the
    # f/c zoom sign (f = zoom in, camera.js:219-225).
    assert b"(held.ArrowRight|0) - (held.ArrowLeft|0)" in body
    assert b"(held.ArrowDown|0) - (held.ArrowUp|0)" in body
    assert b"(held.d|0) - (held.a|0)" in body
    assert b"(held.s|0) - (held.w|0)" in body
    assert b"(held.c|0) - (held.f|0)" in body
    # Shift mid-hold must not leak a stuck key ('f' down, Shift, 'F' up)
    assert b"e.key.toLowerCase()" in body


def test_hud_timing_split(viewer):
    """/stats carries the reference HUD's full timing split
    (index.html:16-34): fps, frame ms, host (JS) ms, compute ms, render
    ms."""
    v, port = viewer
    deadline = time.time() + 20
    while time.time() < deadline:
        _, _, body = _get(port, "/stats")
        s = json.loads(body)
        if s["step"] > 4 and s["fps"] > 0:
            break
        time.sleep(0.1)
    assert s["fps"] > 0
    assert s["frame_ms"] > 0
    assert s["compute_ms"] > 0  # unpaused: sim work measured
    assert s["host_ms"] >= 0
    assert s["render_ms"] > 0


def test_live_resize(viewer):
    """/control?size=WxH changes the render resolution live
    (util.js:91-96) and the stream follows."""
    v, port = viewer
    status, _, _ = _get(port, "/control?size=96x80")
    assert status == 204
    deadline = time.time() + 20
    while time.time() < deadline:
        _, _, body = _get(port, "/stats")
        if json.loads(body)["resolution"] == "96x80":
            break
        time.sleep(0.1)
    assert json.loads(body)["resolution"] == "96x80"
    # the next rendered frame is the new size
    from PIL import Image
    import io

    deadline = time.time() + 20
    while time.time() < deadline:
        _, _, jpg = _get(port, "/frame.jpg")
        img = Image.open(io.BytesIO(jpg))
        if img.size == (96, 80):
            break
        time.sleep(0.1)
    assert img.size == (96, 80)
    # malformed size is ignored, not a 500
    status, _, _ = _get(port, "/control?size=bogus")
    assert status == 204


def test_serve_loop_pipelined_progress(viewer):
    """The round-5 pipelined serve loop (frame begun on the pre-chunk
    state, chunk dispatched, encode overlapping it): as a system it
    must keep BOTH products flowing — physics steps advance AND fresh
    JPEG frames publish — without timing assertions (non-flaky form of
    benchmarks/serve_bench.py)."""
    v, port = viewer
    deadline = time.time() + 60
    seen = []
    while time.time() < deadline and len(seen) < 3:
        _get(port, "/frame.jpg")
        status, _, body = _get(port, "/stats")
        s = json.loads(body)
        if not seen or s["step"] > seen[-1][0]:
            seen.append((s["step"], v._frames_done))
        time.sleep(0.1)
    assert len(seen) >= 3, seen
    # steps advanced monotonically and frames kept publishing alongside
    steps = [s for s, _ in seen]
    frames = [f for _, f in seen]
    assert steps[-1] > steps[0]
    assert frames[-1] > frames[0]
    # HUD stats stay well-formed under the pipelined attribution
    status, _, body = _get(port, "/stats")
    s = json.loads(body)
    assert s["steps_per_s"] >= 0 and s["fps"] >= 0
    assert s["compute_ms"] >= 0 and s["render_ms"] >= 0
