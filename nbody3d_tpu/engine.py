"""Simulation engine: the scheduler/frame-loop layer (SURVEY L7).

The reference runs exactly one physics step per displayed frame, re-queued
via requestAnimationFrame with pause = "skip the compute pass"
(``nbody3d.js:439-506``, ``util.js:56-64``).  This engine decouples
physics from any consumer: K steps run inside one jitted, state-donating
``lax.scan`` (state stays in device memory), and the host taps the state only at
chunk boundaries for logging, rendering, or checkpointing.
"""

from __future__ import annotations

import json
import time
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from nbody3d_tpu.config import SimConfig
from nbody3d_tpu.models.registry import make_preset
from nbody3d_tpu.ops import diagnostics as diag_mod
from nbody3d_tpu.ops.step import make_scan_fn, make_step_fn
from nbody3d_tpu.state import SimState, init_state, pad_count, unpad
from nbody3d_tpu.utils.profiling import Ema, StepStats


class Simulation:
    """Owns a :class:`SimState`, a compiled step loop, and run bookkeeping.

    Single-chip by default; pass ``mesh`` to shard bodies across devices
    (ring/gather strategy per ``config.strategy``).
    """

    def __init__(
        self,
        config: SimConfig,
        pos_mass: np.ndarray | jax.Array,
        vel: np.ndarray | jax.Array,
        accel: np.ndarray | jax.Array | None = None,
        *,
        step: int = 0,
        camera_target: np.ndarray | None = None,
        mesh: jax.sharding.Mesh | None = None,
        platform: str | None = None,
    ):
        self.config = config
        self.mesh = mesh
        self._platform = platform
        # (name, n, preset_kw) when built by from_preset — what regenerate()
        # re-rolls (the reference's regenerate button re-runs main()).
        self._preset: tuple | None = None
        # Full camera pose parsed from a checkpoint, if loaded from one
        # (the reference restores it on import, util.js:247-258).
        self.loaded_camera = None
        self.n_real = int(np.asarray(pos_mass).shape[0])
        # Pad to whole kernel blocks or plain-path chunks (ops/step.py
        # pad_multiple); sharding additionally needs equal, aligned shards
        # per device.
        from nbody3d_tpu.ops.step import pad_multiple

        multiple = pad_multiple(config, self.n_real, platform)
        if mesh is not None:
            multiple *= mesh.size  # total devices (1-D ring or 2-D grid)
        self.n_pad = pad_count(self.n_real, multiple)
        # Total mass, cached host-side: the comoving background's rho_bar
        # (scale_factor below) — one column sum at init, not per query.
        # Invariant: every integrator passes the mass column through
        # untouched (ops/integrate.py, ops/expansion.py) and no code path
        # mutates masses in place, so this host mirror stays structurally
        # tied to the in-trace background, which re-derives rho_bar from
        # the live state each step.  Any future mass-mutating feature must
        # refresh (or remove) this cache or scale_factor silently diverges.
        self._mass_total = float(np.asarray(pos_mass)[:, 3].sum())
        self.state = init_state(pos_mass, vel, accel, n_pad=self.n_pad, step=step)
        self._step_count = int(step)  # last value seen at a chunk boundary
        self.camera_target = (
            np.zeros(3) if camera_target is None else np.asarray(camera_target, dtype=np.float64)
        )

        if mesh is None:
            self._step_fn = make_step_fn(config, self.n_pad, self.n_real, platform)
        else:
            from nbody3d_tpu.parallel.sharded import make_sharded_step, shard_state

            self._step_fn = make_sharded_step(
                config, self.n_pad, self.n_real, mesh, platform
            )
            axis = None if config.strategy == "2d" else config.mesh_axis
            self.state = shard_state(self.state, mesh, axis)
        self._run_chunk = make_scan_fn(self._step_fn)

        # Live-tunable runtime params (the dt/G sliders, util.js:38-54) and
        # pause semantics (dt <-> 0 swap through oldDt, util.js:56-64).
        # Direct slot writes: the dt/G property setters guard against
        # mid-run changes on cosmology runs (see their docstring), which
        # construction is not.
        self._dt = float(config.dt)
        self._G = float(config.G)
        self._old_dt: float | None = None

        # EMA-filtered profiling, filterStrength=10 like the reference HUD
        # (nbody3d.js:434,441-443).
        self.stats = StepStats(ema=Ema(10.0))
        # Optional structured metrics sink: one JSON line per scan chunk
        # (SURVEY §5.5 — the persistent-log upgrade over the reference's
        # transient HUD spans).
        self.metrics_path: str | None = None
        # Render-pass observability (HUD parity: render ms + camera pose).
        self.last_render_ms: float | None = None
        self.last_render_info: str | None = None

    # ------------------------------------------------------------------ run
    @classmethod
    def from_preset(
        cls,
        name: str,
        config: SimConfig | None = None,
        *,
        n: int | None = None,
        mesh: jax.sharding.Mesh | None = None,
        platform: str | None = None,
        **preset_kw,
    ) -> "Simulation":
        config = config or SimConfig()
        pos_mass, vel, target = make_preset(
            name,
            seed=config.seed,
            G=config.G,
            n=n,
            size_factor=config.size_factor,
            **preset_kw,
        )
        sim = cls(
            config, pos_mass, vel, camera_target=target, mesh=mesh, platform=platform
        )
        sim._preset = (name, n, dict(preset_kw))
        return sim

    def regenerate(self, seed: int | None = None, **settings) -> "Simulation":
        """Build a fresh Simulation from the same preset with new randomness —
        the reference's regenerate button (``util.js:69-75``: cancel the loop,
        re-run ``main()``).  Returns the new sim; the caller swaps it in.

        ``settings`` are the reference's galaxy settings panel
        (``index.html:68-75``): ``num_galaxies``, ``min_bodies``,
        ``max_bodies``.  The reference's ``main()`` always reads the panel,
        so passing any of them regenerates as a reference-shaped random
        galaxy run (the ``reference-random`` preset) whatever the current
        preset is."""
        if self._preset is None:
            raise ValueError(
                "regenerate requires a preset-built simulation "
                "(Simulation.from_preset)"
            )
        name, n, kw = self._preset
        if settings:
            base = kw if name == "reference-random" else {}
            name, n, kw = "reference-random", None, {**base, **settings}
        if seed is None:
            seed = int(np.random.SeedSequence().generate_state(1)[0]) & 0x7FFFFFFF
        # The reference's main() reads the LIVE G/dt globals (slider state)
        # at generation time — circular-orbit speeds use the current G
        # (nbody3d.js:115) — so carry the runtime values, not the
        # construction-time config.
        dt_live = self._old_dt if self._old_dt is not None else self.dt
        config = self.config.replace(seed=seed, G=self.G, dt=dt_live)
        return Simulation.from_preset(
            name, config, n=n, mesh=self.mesh, platform=self._platform, **kw
        )

    # -------------------------------------------------- live dt/G (sliders)
    @property
    def dt(self) -> float:
        return self._dt

    @dt.setter
    def dt(self, v: float) -> None:
        self._guard_cosmo_param("dt", float(v))
        self._dt = float(v)

    @property
    def G(self) -> float:
        return self._G

    @G.setter
    def G(self, v: float) -> None:
        self._guard_cosmo_param("G", float(v))
        self._G = float(v)

    def _guard_cosmo_param(self, name: str, v: float) -> None:
        """Reject live dt/G changes on a comoving run that already has
        history: the background (both the in-trace integration in
        ops/expansion.py and the host mirror in :attr:`scale_factor`)
        reconstructs cosmic time as ``t_i + step*dt`` from the CURRENT
        dt and G, so changing either mid-run would silently rescale the
        entire expansion history.  Pause (dt=0 swap) stays allowed —
        steps don't advance, so no history is distorted.  Checkpoint
        restore goes through :meth:`_set_runtime`, which bypasses this
        guard to re-install the authoritative saved values."""
        if self.config.cosmology == "none":
            return
        cur = self._dt if name == "dt" else self._G
        if v == cur or (name == "dt" and v == 0.0):
            return  # no-op or pause
        if name == "dt" and self._old_dt is not None and v == self._old_dt:
            return  # unpause restore
        if self._step_count == 0 and self.stats.total_steps == 0:
            return  # no history yet — the run starts from here
        raise ValueError(
            f"cannot change {name} mid-run with cosmology="
            f"{self.config.cosmology!r}: the comoving background integrates "
            f"from t_i with constant dt/G, so a live change would rescale "
            f"the entire expansion history (ops/expansion.py).  Pause, or "
            f"regenerate/restart with the new value."
        )

    def _set_runtime(self, dt: float | None = None, G: float | None = None):
        """Install runtime dt/G bypassing the cosmology guard — for
        checkpoint restore, where the saved values ARE the ones that
        produced the existing history."""
        if dt is not None:
            self._dt = float(dt)
        if G is not None:
            self._G = float(G)

    @property
    def paused(self) -> bool:
        return self._old_dt is not None

    def toggle_pause(self) -> None:
        """Pause = dt swapped to 0; the engine then skips stepping entirely,
        matching the reference's skipped compute pass (``nbody3d.js:474``) —
        and crucially keeps the lagged acceleration unchanged."""
        if self._old_dt is None:
            self._old_dt, self.dt = self.dt, 0.0
        else:
            self.dt, self._old_dt = self._old_dt, None

    def run(self, n_steps: int, *, chunk: int = 100) -> SimState:
        """Advance ``n_steps`` in jitted chunks, updating profiling stats."""
        if self.dt == 0.0:
            return self.state
        remaining = n_steps
        while remaining > 0:
            self._maybe_wrap_box()
            k = min(chunk, remaining)
            t0 = time.perf_counter()
            self.state = self._run_chunk(self.state, self.dt, self.G, k)
            jax.block_until_ready(self.state)
            elapsed = time.perf_counter() - t0
            self.stats.update(k, elapsed, self.pair_interactions_per_step)
            if self.metrics_path:
                self._append_metrics(k, elapsed)
            remaining -= k
        return self.state

    def _append_metrics(self, k: int, elapsed: float) -> None:
        rec = {
            "t": time.time(),
            "step": int(self.stats.total_steps),
            "chunk": k,
            "wall_s": round(elapsed, 6),
            "steps_per_s": round(self.stats.steps_per_s, 3),
            "gints_per_s": round(self.stats.gints_per_s, 4),
            "n_bodies": self.n_real,
            "dt": self.dt,
            "G": self.G,
        }
        if self.last_render_ms is not None:
            rec["render_ms"] = round(self.last_render_ms, 3)
            rec["render_info"] = self.last_render_info
        a = self.scale_factor
        if a is not None:
            rec["a"] = round(a, 6)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def step(self, n: int = 1) -> SimState:
        return self.run(n, chunk=n)

    def _sharded_render(self, camera, width, height, color_mode):
        """Dispatch a sharded device-resolve frame of the current state
        (render/sharded.py; the closure is cached per frame shape) and
        return its handle for ``sharded_frame_image``."""
        key = (width, height, color_mode)
        cache = getattr(self, "_sharded_render_cache", None)
        if cache is None:
            cache = self._sharded_render_cache = {}
        render = cache.get(key)
        if render is None:
            from nbody3d_tpu.render.sharded import make_sharded_render

            render = cache[key] = make_sharded_render(
                self.mesh, self.n_pad, self.n_real,
                width=width, height=height,
                size_factor=self.config.size_factor,
                color_mode=color_mode,
                axis=(
                    None if self.config.strategy == "2d"
                    else self.config.mesh_axis
                ),
            )
        vp, f = camera.view_proj(width / height)
        return render(
            self.state.pos_mass, self.state.vel, vp, f, camera.position
        )

    # ----------------------------------------------- pipelined chunk API
    def run_async(self, k: int):
        """Dispatch ONE scan chunk of ``k`` steps WITHOUT waiting for it:
        the jitted scan is queued on the device and this returns
        immediately with a token for :meth:`wait_chunk`.  Device work
        dispatched BEFORE this call (e.g. a frame's projection/resolve
        against the pre-chunk state) executes first in queue order, so
        the viewer can overlap its host-side frame work (fetch + JPEG
        encode) with the chunk's device time — the pipelined serve
        loop.  Returns None (and runs nothing) while paused."""
        if self.dt == 0.0 or k <= 0:
            return None
        self._maybe_wrap_box()
        t0 = time.perf_counter()
        self.state = self._run_chunk(self.state, self.dt, self.G, k)
        return (k, t0)

    def wait_chunk(self, token) -> None:
        """Block until the chunk dispatched by :meth:`run_async` has
        executed, then update the profiling stats with the full
        dispatch-to-done wall time."""
        if token is None:
            return
        k, t0 = token
        jax.block_until_ready(self.state)
        elapsed = time.perf_counter() - t0
        self.stats.update(k, elapsed, self.pair_interactions_per_step)
        if self.metrics_path:
            self._append_metrics(k, elapsed)

    def _maybe_wrap_box(self) -> None:
        """Periodic boundary: re-wrap positions into [0, L)^3 at chunk
        boundaries.  The solvers wrap internally every step (physics is
        exact regardless of drift); this host-cadence wrap keeps the
        STORED state in-box so checkpoints, renders, and analysis see
        canonical coordinates, and bounds f32 position magnitudes."""
        if self.config.boundary != "periodic":
            return
        from nbody3d_tpu.ops.ewald import wrap_box

        p = self.state.pos_mass
        wrapped = jnp.concatenate(
            [wrap_box(p[:, :3], jnp.float32(self.config.box_size)), p[:, 3:4]],
            axis=1,
        )
        self.state = SimState(
            wrapped, self.state.vel, self.state.accel, self.state.step
        )

    @property
    def scale_factor(self) -> float | None:
        """Current background scale factor ``a(t)`` of a comoving run
        (``None`` for static space) — the HUD-class observability that
        makes an expanding-universe run legible (ops/expansion.py's
        host mirror of the in-trace background)."""
        if self.config.cosmology == "none":
            return None
        from nbody3d_tpu.ops.expansion import cosmic_time_and_scale

        rho_bar = self._mass_total / float(self.config.box_size) ** 3
        dt = self._old_dt if self._old_dt is not None else self.dt
        _, a = cosmic_time_and_scale(
            self.config, self.G, rho_bar, self.step_count, dt
        )
        return a

    @property
    def pair_interactions_per_step(self) -> int:
        """N^2 - N per force evaluation, the reference's work definition
        (``nbody3d.js:255-268``, BASELINE 'pair interactions per step'),
        times the integrator's force evaluations per step (yoshida4: 3) —
        so the reported G-int/s rate stays an honest work rate."""
        from nbody3d_tpu.ops.integrate import FORCE_EVALS

        evals = FORCE_EVALS.get(self.config.integrator, 1)
        return (self.n_real * self.n_real - self.n_real) * evals

    # ---------------------------------------------------------- inspection
    @property
    def step_count(self) -> int:
        try:
            self._step_count = int(jax.device_get(self.state.step))
        except RuntimeError:
            # A scan chunk currently owns the donated state buffers (the
            # viewer loop thread donates ``state`` into ``_run_chunk``), so
            # the device array is transiently deleted.  Serve the last value
            # observed at a chunk boundary instead of raising into e.g. the
            # viewer's HTTP thread.
            pass
        return self._step_count

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of the real (unpadded) pos_mass, vel, accel."""
        return unpad(self.state, self.n_real)

    def diagnostics(self, chunk: int | None = 1024) -> diag_mod.Diagnostics:
        """Energy/momentum diagnostics.

        Computed on the *padded* device state: mass-0 padding bodies
        contribute exactly zero to every mass-weighted sum, and padding
        keeps the O(N^2/chunk) blocking aligned (an unchunked (N, N)
        pair matrix would be gigabytes at the reference-default N).
        """
        if self.mesh is not None and self.config.boundary != "periodic":
            # (periodic falls through to the Ewald branch below: the
            # sharded diagnostics compute the ISOLATED pair potential,
            # which is not the torus's conserved energy.  The jnp ops
            # below accept sharded global arrays.)
            from nbody3d_tpu.parallel.sharded import make_sharded_diagnostics

            if not hasattr(self, "_sharded_diag"):
                self._sharded_diag = make_sharded_diagnostics(
                    self.config, self.n_pad, self.mesh
                )
            return jax.device_get(self._sharded_diag(self.state, self.G))
        from nbody3d_tpu.ops.step import fit_block

        if chunk is not None:
            # Bound the O(chunk * N) pair-matrix temporaries to ~1 GB: at
            # N=2M an unchecked 1024-chunk would need 16 GB per temp.
            mem_cap = max(8, (1 << 28) // max(self.n_pad, 1))
            chunk = fit_block(self.n_pad, min(chunk, mem_cap))
        if self.config.boundary == "periodic":
            # The conserved energy on the torus is the EWALD potential
            # (ops/ewald.py) — the isolated pair sum is not a constant of
            # the periodic motion.  Padding rows carry zero mass, so they
            # drop from every term.  A SHARDED state is gathered to host
            # first: the real-space term's (chunk, N) pair matrix cannot
            # be formed from two axis-sharded operands (illegal
            # N@x x N@x sharding), and diagnostics run per chunk, not
            # per step.
            # Host float64 throughout: the Ewald value is a catastrophic
            # cancellation (self + background constants ~1e7-1e8 against a
            # physical total of O(1e2)); an f32 evaluation carries ~1e2 of
            # rounding noise that swamps any real drift signal (see
            # ewald_potential_energy_f64's docstring).  O(N^2) on host —
            # diagnostics cadence only.
            from nbody3d_tpu.ops.ewald import ewald_potential_energy_f64

            pm_h = np.asarray(jax.device_get(self.state.pos_mass), np.float64)
            vel_h = np.asarray(jax.device_get(self.state.vel), np.float64)
            m = pm_h[:, 3:4]
            ke = 0.5 * float(np.sum(m[:, 0] * np.sum(vel_h[:, :3] ** 2, axis=1)))
            pe = float(self.G) * ewald_potential_energy_f64(
                pm_h, float(self.config.box_size), eps2=self.config.eps2
            )
            mom = (m * vel_h[:, :3]).sum(axis=0)
            ang = (m * np.cross(pm_h[:, :3], vel_h[:, :3])).sum(axis=0)
            return diag_mod.Diagnostics(
                kinetic=np.float64(ke),
                potential=np.float64(pe),
                total_energy=np.float64(ke + pe),
                momentum=mom,
                angular_momentum=ang,
                total_mass=np.float64(m.sum()),
            )
        return jax.device_get(
            diag_mod.compute(
                self.state.pos_mass,
                self.state.vel,
                self.G,
                eps2=self.config.eps2,
                chunk=chunk,
            )
        )

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Save a checkpoint; format by suffix: ``.json`` = reference
        schema, ``.npz`` = native binary, anything else = orbax directory."""
        from nbody3d_tpu.utils import checkpoint

        p = str(path)
        if p.endswith(".json"):
            checkpoint.save_reference_json(path, self)
        elif p.endswith(".npz"):
            checkpoint.save_npz(path, self)
        else:
            checkpoint.save_orbax(path, self)

    @classmethod
    def load(
        cls,
        path: str,
        config: SimConfig | None = None,
        *,
        mesh: jax.sharding.Mesh | None = None,
        platform: str | None = None,
    ) -> "Simulation":
        from nbody3d_tpu.utils import checkpoint

        p = str(path)
        if p.endswith(".json"):
            return checkpoint.load_reference_json(
                path, config, mesh=mesh, platform=platform
            )
        if p.endswith(".npz"):
            return checkpoint.load_npz(path, config, mesh=mesh, platform=platform)
        return checkpoint.load_orbax(path, config, mesh=mesh, platform=platform)

    # -------------------------------------------------------------- render
    def render_frame(
        self,
        camera=None,
        *,
        width: int = 1024,
        height: int = 768,
        color_mode: str = "magnitude",
        resolve: str = "auto",
    ):
        """Headless point-splat frame of the current state (SURVEY P3).

        ``resolve="device"`` rasterizes on the accelerator (small splats
        scatter-min into the framebuffer; render/rasterize.py), so only
        the 4 B/pixel image and the few large splats leave the device —
        the practical mode at millions of bodies.  On a mesh it renders
        each shard where it lives (render/sharded.py).
        """
        return self.render_frame_finish(self.render_frame_begin(
            camera, width=width, height=height, color_mode=color_mode,
            resolve=resolve,
        ))

    def render_frame_begin(
        self,
        camera=None,
        *,
        width: int = 1024,
        height: int = 768,
        color_mode: str = "magnitude",
        resolve: str = "auto",
    ):
        """Phase 1 of a pipelined frame: capture/dispatch everything the
        frame needs from the CURRENT state, so a physics chunk may be
        dispatched (donating that state) before
        :meth:`render_frame_finish` does the host-side work.  With
        ``resolve="device"`` the projection and scatter resolve are queued
        on the device with no host transfer; other resolves snapshot the
        state to the host and rasterize in finish."""
        from nbody3d_tpu.utils.camera import Camera

        if camera is None:
            camera = Camera(target=self.camera_target)
        t0 = time.perf_counter()
        if resolve == "device" and self.mesh is not None:
            snap = ("sharded", self._sharded_render(
                camera, width, height, color_mode
            ))
        elif resolve == "device":
            from nbody3d_tpu.render.rasterize import device_resolve_begin

            # device slices, not host copies: per-body data stays on the
            # device (padding excluded — mass-0 pad bodies would still
            # splat through the min-size clamp).
            snap = ("device", device_resolve_begin(
                self.state.pos_mass[: self.n_real],
                self.state.vel[: self.n_real],
                camera, width=width, height=height,
                size_factor=self.config.size_factor, color_mode=color_mode,
            ))
        else:
            pm, v, _ = self.arrays()  # host copies
            snap = ("host", (pm, v))
        return {
            "snap": snap, "camera": camera, "width": width,
            "height": height, "color_mode": color_mode, "resolve": resolve,
            "begin_ms": (time.perf_counter() - t0) * 1e3,
        }

    def render_frame_finish(self, handle):
        """Phase 2 of a pipelined frame: host fetch/composite/assembly.
        Returns the (H, W, 3) uint8 image and records the render time
        (begin + finish) and camera pose for the HUD/metrics."""
        from nbody3d_tpu.render.rasterize import (
            device_resolve_finish,
            render_points,
        )

        t0 = time.perf_counter()
        kind, payload = handle["snap"]
        if kind == "sharded":
            from nbody3d_tpu.render.sharded import sharded_frame_image

            img = sharded_frame_image(payload)
        elif kind == "device":
            img = device_resolve_finish(payload)
        else:
            pm, v = payload
            img = render_points(
                pm, v, handle["camera"],
                width=handle["width"], height=handle["height"],
                size_factor=self.config.size_factor,
                color_mode=handle["color_mode"],
                resolve=handle["resolve"],
            )
        cam = handle["camera"]
        self.last_render_ms = handle["begin_ms"] + (
            time.perf_counter() - t0
        ) * 1e3
        self.last_render_info = (
            f"{handle['width']}x{handle['height']} {cam.describe()}"
        )
        return img

    # ------------------------------------------------------------- logging
    def log_lines(self) -> Iterator[str]:
        """Structured per-interval log: the HUD equivalent (SURVEY §5.5)."""
        s = self.stats
        a = self.scale_factor
        yield (
            f"step={self.step_count} steps/s={s.steps_per_s:.2f} "
            f"Gints/s={s.gints_per_s:.2f} wall_ms/step={s.ms_per_step:.3f} "
            f"N={self.n_real} dt={self.dt:g} G={self.G:g}"
            + (f" a={a:.4f}" if a is not None else "")
        )
        if self.last_render_ms is not None:
            yield (
                f"  render_ms={self.last_render_ms:.1f} {self.last_render_info}"
            )
