"""End-to-end interactive viewer benchmark.

The reference's whole product is its vsync-coupled interactive loop with
a live FPS HUD (``nbody3d.js:439-514``); this harness states the
rebuild's equivalent as ONE measured table: physics steps/s, served
fps, and control->frame latency for `cli serve` as a SYSTEM — the
pipelined loop (viewer.py round 5: frame device work dispatched against
the pre-chunk state, physics chunk dispatched, host fetch + JPEG encode
overlapping the chunk) driven over real HTTP.

Usage:
  python benchmarks/serve_bench.py                      # N=40,002 direct
  python benchmarks/serve_bench.py --method pm --n 2097152 --steps-per-frame 5
  python benchmarks/serve_bench.py --platform cpu --n 2048 --seconds 5

Metrics:
  steps/s   — physics rate while serving (from /stats step deltas)
  fps       — MJPEG frames delivered over /stream
  latency   — /control request -> next TWO stream frames (the first
              in-flight frame may predate the control; the second is
              guaranteed to reflect it, since the loop snapshots the
              camera at frame begin)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_stream_frames(url, stop, counter):
    """Count multipart frame boundaries on /stream until ``stop`` set;
    appends arrival timestamps to ``counter``."""
    req = urllib.request.urlopen(url, timeout=30)
    buf = b""
    while not stop.is_set():
        chunk = req.read(4096)
        if not chunk:
            break
        buf += chunk
        while b"--frame" in buf:
            counter.append(time.perf_counter())
            buf = buf.split(b"--frame", 1)[1]
    req.close()


def get_stats(base, timeout=30):
    with urllib.request.urlopen(base + "/stats", timeout=timeout) as r:
        return json.loads(r.read())


def get_stats_patient(base, deadline):
    """get_stats that survives the warmup window: while the first jit
    compiles run, the server threads can be starved — retry until
    ``deadline`` instead of dying on one 30 s socket timeout."""
    while True:
        try:
            return get_stats(base, timeout=60)
        except (TimeoutError, OSError):
            if time.time() > deadline:
                raise
            time.sleep(2.0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=40_002)
    ap.add_argument("--method", default="direct", choices=["direct", "pm", "p3m"])
    ap.add_argument("--steps-per-frame", type=int, default=20)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--resolve", default="auto")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--platform", default="auto")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()

    import jax

    if args.platform != "auto":
        jax.config.update("jax_platforms", args.platform)
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from nbody3d_tpu.config import SimConfig
    from nbody3d_tpu.engine import Simulation
    from nbody3d_tpu.viewer import LiveViewer

    config = SimConfig(method=args.method)
    sim = Simulation.from_preset(
        "two-galaxy" if args.method == "direct" else "uniform-sphere",
        config, n=args.n,
    )
    viewer = LiveViewer(
        sim, width=args.width, height=args.height,
        steps_per_frame=args.steps_per_frame, resolve=args.resolve,
    )
    server = viewer.make_server("127.0.0.1", args.port)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    viewer.start()

    # warmup: first frames pay jit compiles, which can starve the server
    # threads — be patient, not strict
    t_end = time.time() + float(os.environ.get("NBODY_SERVE_WARMUP_S", "600"))
    while time.time() < t_end:
        s = get_stats_patient(base, t_end)
        if s["step"] >= 2 * args.steps_per_frame and viewer._frame:
            break
        time.sleep(0.5)

    stamps: list[float] = []
    stop = threading.Event()
    reader = threading.Thread(
        target=read_stream_frames, args=(base + "/stream", stop, stamps),
        daemon=True,
    )
    reader.start()
    s0 = get_stats(base)
    t0 = time.perf_counter()
    time.sleep(args.seconds)
    s1 = get_stats(base)
    t1 = time.perf_counter()

    window = [t for t in stamps if t0 <= t <= t1]
    fps = len(window) / (t1 - t0)
    steps_per_s = (s1["step"] - s0["step"]) / (t1 - t0)

    # control latency: orbit request -> first and second following frame
    lat1 = []
    lat2 = []
    for _ in range(5):
        n_before = len(stamps)
        tc = time.perf_counter()
        with urllib.request.urlopen(
            base + "/control?orbit=0.05,0.02", timeout=30
        ):
            pass
        stop2 = time.time() + 60
        while len(stamps) < n_before + 2 and time.time() < stop2:
            time.sleep(0.005)
        if len(stamps) >= n_before + 1:
            lat1.append(stamps[n_before] - tc)
        if len(stamps) >= n_before + 2:
            lat2.append(stamps[n_before + 1] - tc)
    stop.set()

    med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")
    out = {
        "n": args.n,
        "method": args.method,
        "steps_per_frame": args.steps_per_frame,
        "resolution": f"{args.width}x{args.height}",
        "resolve": args.resolve,
        "platform": s1.get("platform", args.platform),
        "steps_per_s": round(steps_per_s, 2),
        "served_fps": round(fps, 2),
        "frame_ms_hud": round(s1["frame_ms"], 1),
        "compute_ms_hud": round(s1["compute_ms"], 1),
        "render_ms_hud": round(s1["render_ms"], 1),
        "control_to_next_frame_s": round(med(lat1), 3),
        "control_to_reflected_frame_s": round(med(lat2), 3),
    }
    print(json.dumps(out))
    viewer.stop()
    server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
