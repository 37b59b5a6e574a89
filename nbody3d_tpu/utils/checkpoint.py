"""Checkpoint / resume (SURVEY §5.4).

Two formats:

- **Reference-schema JSON** — byte-compatible with the WebGPU app's
  export/import (``util.js:160-263``): flat float lists ``bodies`` /
  ``vel`` / ``accel`` (the lagged Verlet makes accel part of the state),
  an 8-field ``camera`` dict, and ``G`` as the log10 slider value rendered
  with 2 decimals (``util.js:200``: ``parseFloat(ui.G.value).toFixed(2)``).
  Files exported by the reference load here and vice versa.  The
  reference's known gaps are fixed additively: we also write ``dt``,
  ``step`` and ``nBodies`` (extra keys the reference simply ignores), and
  loading *validates* N instead of silently corrupting buffers
  (``util.js:230-244`` has no check).

- **Native .npz** — binary arrays + step counter + full config, ~8x smaller
  than JSON doubles and the format the CLI uses for periodic checkpoints.

- **Orbax directory** — production checkpointing via orbax (atomic,
  versionable, sharding-aware on restore); selected when the target path
  has no ``.json``/``.npz`` suffix.
"""

from __future__ import annotations

import json
import math

import numpy as np

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.utils.camera import Camera


def _sim_arrays(sim) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return sim.arrays()


# ------------------------------------------------------------ reference JSON
def save_reference_json(path: str, sim, camera: Camera | None = None) -> None:
    pos_mass, vel, accel = _sim_arrays(sim)
    if camera is None:
        camera = Camera(target=sim.camera_target)
    if not sim.G > 0:
        raise ValueError(
            f"reference-JSON export stores G as its log10 slider value "
            f"(util.js:200) and quantizes it to 2 decimals, which requires "
            f"G > 0 (got {sim.G!r}); use the lossless .npz format instead"
        )
    meta = {
        "camera": camera.to_dict(),
        "G": f"{math.log10(sim.G):.2f}",  # util.js:200 slider-value string
        # Additive fixes for reference gaps (ignored by the WebGPU app):
        "dt": sim.dt,
        "step": sim.step_count,
        "nBodies": sim.n_real,
    }

    from nbody3d_tpu import native

    chunks = (
        [native.dumps_f32(a) for a in (pos_mass, vel, accel)]
        if native.fastjson is not None
        else [None, None, None]
    )
    if all(c is not None for c in chunks):
        # Native codec: ~20x faster than boxing 12M floats at 500k bodies;
        # %.9g digits round-trip every float32 exactly (native/_fastjson.c).
        # Assembled with json.dump's separators so the document is
        # indistinguishable from the pure-Python writer apart from digit
        # spelling.
        with open(path, "wb") as f:
            f.write(b'{"bodies": ' + chunks[0])
            f.write(b', "vel": ' + chunks[1])
            f.write(b', "accel": ' + chunks[2])
            for k, v in meta.items():
                f.write(b", " + json.dumps(k).encode() + b": " + json.dumps(v).encode())
            f.write(b"}")
        return
    data = {
        "bodies": [float(v) for v in pos_mass.reshape(-1)],
        "vel": [float(v) for v in vel.reshape(-1)],
        "accel": [float(v) for v in accel.reshape(-1)],
        **meta,
    }
    with open(path, "w") as f:
        json.dump(data, f)


def _parse_fast(raw: bytes):
    """Native-codec parse of the three state arrays (None -> fall back):
    scan each JSON number array in place, then json-parse the small
    remainder (camera/G/dt/...) with the arrays excised."""
    from nbody3d_tpu import native

    if native.fastjson is None:
        return None
    try:
        arrays, spans = {}, []
        for key in ("bodies", "vel", "accel"):
            kpos = raw.find(b'"%s"' % key.encode())
            if kpos < 0:
                return None
            astart = raw.index(b"[", kpos)
            arr, end = native.scan_f32(raw, astart)
            arrays[key] = arr
            spans.append((astart, end))
        spans.sort()
        parts, prev = [], 0
        for s, e in spans:
            parts.append(raw[prev:s] + b"[]")
            prev = e
        parts.append(raw[prev:])
        meta = json.loads(b"".join(parts))
        return arrays, meta
    except (ValueError, json.JSONDecodeError):
        return None


def parse_reference_json(path: str):
    """Parse a reference-schema file into arrays + metadata without building
    a Simulation (shared by the loader and the format-conversion CLI)."""
    with open(path, "rb") as f:
        raw = f.read()
    fast = _parse_fast(raw)
    if fast is not None:
        arrays, data = fast
        bodies = arrays["bodies"].reshape(-1, 4)
        vel = arrays["vel"].reshape(-1, 4)
        accel = arrays["accel"].reshape(-1, 4)
    else:
        data = json.loads(raw)
        bodies = np.asarray(data["bodies"], dtype=np.float32).reshape(-1, 4)
        vel = np.asarray(data["vel"], dtype=np.float32).reshape(-1, 4)
        accel = np.asarray(data["accel"], dtype=np.float32).reshape(-1, 4)
    n = bodies.shape[0]
    if vel.shape[0] != n or accel.shape[0] != n:
        raise ValueError(
            f"checkpoint arrays disagree on N: bodies={n}, vel={vel.shape[0]}, "
            f"accel={accel.shape[0]}"
        )
    declared = data.get("nBodies")
    if declared is not None and int(declared) != n:
        raise ValueError(f"checkpoint declares nBodies={declared} but has {n} bodies")
    G = 10.0 ** float(data["G"]) if "G" in data else None  # util.js:261
    camera = Camera.from_dict(data["camera"]) if "camera" in data else None
    dt = float(data["dt"]) if "dt" in data else None
    step = int(data.get("step", 0))
    return bodies, vel, accel, camera, G, dt, step


def load_reference_json(path: str, config: SimConfig | None = None, *, mesh=None, platform=None):
    from nbody3d_tpu.engine import Simulation

    bodies, vel, accel, camera, G, dt, step = parse_reference_json(path)
    config = config or SimConfig()
    if G is not None:
        config = config.replace(G=G)
    if dt is not None:
        config = config.replace(dt=dt)
    sim = Simulation(
        config,
        bodies,
        vel,
        accel,
        step=step,
        camera_target=camera.target if camera is not None else None,
        mesh=mesh,
        platform=platform,
    )
    sim.loaded_camera = camera
    return sim


def peek_config(path: str) -> SimConfig | None:
    """Read just the saved :class:`SimConfig` from a checkpoint, or None
    for reference-JSON files (which carry no config beyond G/dt)."""
    p = str(path)
    if p.endswith(".json"):
        return None
    if p.endswith(".npz"):
        with np.load(p) as z:
            return SimConfig.from_json(bytes(z["config_json"]).decode())
    import os

    ocp = _orbax()

    with ocp.PyTreeCheckpointer() as ckptr:
        # Partial restore: only the config entry, not the body arrays
        # (which can be ~100 MB at large N and are loaded again by
        # load_orbax anyway).  transforms={} drops everything not named
        # in the item skeleton.
        try:
            tree = ckptr.restore(
                os.path.abspath(p), item={"config_json": ""}, transforms={}
            )
        except TypeError:  # older orbax without item/transforms kwargs
            tree = ckptr.restore(os.path.abspath(p))
    return SimConfig.from_json(str(tree["config_json"]))


# -------------------------------------------------------------------- orbax
def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise RuntimeError(
            "orbax checkpoint directories need orbax-checkpoint "
            "(pip install orbax-checkpoint); .npz and .json need nothing"
        ) from e
    return ocp


def save_orbax(path: str, sim, camera: Camera | None = None) -> None:
    import os

    ocp = _orbax()

    pos_mass, vel, accel = _sim_arrays(sim)
    if camera is None:
        camera = Camera(target=sim.camera_target)
    config = sim.config.replace(dt=sim.dt, G=sim.G)
    tree = {
        "pos_mass": pos_mass,
        "vel": vel,
        "accel": accel,
        "step": np.int64(sim.step_count),
        "config_json": config.to_json(),
        "camera_json": json.dumps(camera.to_dict()),
    }
    path = os.path.abspath(path)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, tree, force=True)


def load_orbax(path: str, config: SimConfig | None = None, *, mesh=None, platform=None):
    import os

    ocp = _orbax()

    from nbody3d_tpu.engine import Simulation

    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(os.path.abspath(path))
    saved_config = SimConfig.from_json(str(tree["config_json"]))
    camera = Camera.from_dict(json.loads(str(tree["camera_json"])))
    if config is None:
        config = saved_config
    sim = Simulation(
        config,
        np.asarray(tree["pos_mass"]),
        np.asarray(tree["vel"]),
        np.asarray(tree["accel"]),
        step=int(tree["step"]),
        camera_target=camera.target,
        mesh=mesh,
        platform=platform,
    )
    sim.dt = config.dt
    sim.G = config.G
    sim.loaded_camera = camera
    return sim


# ------------------------------------------------------------------ native npz
def save_npz(path: str, sim, camera: Camera | None = None) -> None:
    pos_mass, vel, accel = _sim_arrays(sim)
    if camera is None:
        camera = Camera(target=sim.camera_target)
    config = sim.config.replace(dt=sim.dt, G=sim.G)
    np.savez_compressed(
        path,
        pos_mass=pos_mass,
        vel=vel,
        accel=accel,
        step=np.int64(sim.step_count),
        config_json=np.bytes_(config.to_json().encode()),
        camera_json=np.bytes_(json.dumps(camera.to_dict()).encode()),
    )


def load_npz(path: str, config: SimConfig | None = None, *, mesh=None, platform=None):
    from nbody3d_tpu.engine import Simulation

    with np.load(path) as z:
        pos_mass = z["pos_mass"]
        vel = z["vel"]
        accel = z["accel"]
        step = int(z["step"])
        saved_config = SimConfig.from_json(bytes(z["config_json"]).decode())
        camera = Camera.from_dict(json.loads(bytes(z["camera_json"]).decode()))
    if config is None:
        config = saved_config
    sim = Simulation(
        config,
        pos_mass,
        vel,
        accel,
        step=step,
        camera_target=camera.target,
        mesh=mesh,
        platform=platform,
    )
    sim.dt = config.dt
    sim.G = config.G
    sim.loaded_camera = camera
    return sim
