"""Command-line interface — the framework surface (SURVEY P4).

Replaces the reference's UI layer (``index.html`` controls + ``util.js``
listeners, SURVEY C12) with subcommands:

- ``run``      simulate a preset or checkpoint with periodic logging,
               checkpoints and frame dumps (the decoupled "frame loop").
- ``bench``    throughput benchmark printing one JSON line
               (steps/s + G pairwise interactions/s).
- ``render``   rasterize a checkpoint to PNG.
- ``animate``  orbiting-camera PNG sequence (scripted stand-in for the
               interactive orbit controls, ``camera.js:143-168``).
- ``convert``  convert checkpoints between reference JSON, native npz and
               orbax (the export/import buttons, ``util.js:265-274``).
- ``info``     platform/mesh report (the WebGPU-support check,
               ``nbody3d.js:139-155``).

dt and G accept either linear values (``--dt 1e-4``) or the reference's
log-slider values (``--log-dt -4``; ``util.js:38-54``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--platform",
        default="auto",
        choices=["auto", "cpu", "gpu"],
        help="force the JAX platform (cpu is handy for render/convert work "
        "that doesn't need the accelerator)",
    )
    # Defaults are None sentinels so that resuming a checkpoint keeps its
    # saved config except for flags the user explicitly set (the reference's
    # import likewise restores the file's G, util.js:259-262).
    p.add_argument("--dt", type=float, default=None, help="timestep (default 1e-4)")
    p.add_argument("--log-dt", type=float, default=None, help="dt = 10**value (slider semantics)")
    p.add_argument("--G", type=float, default=None, help="gravitational constant (default 1e-4)")
    p.add_argument("--log-G", type=float, default=None, help="G = 10**value (slider semantics)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--backend", default=None,
        choices=["auto", "pallas", "pallas_interpret", "jnp"],
        help="direct-force implementation: auto = the Triton kernel on the "
        "GPU, plain jnp elsewhere; pallas = the kernel (GPU only); "
        "pallas_interpret = the kernel in the Pallas interpreter; jnp = "
        "the plain sum (ops/step.py resolve_backend)",
    )
    p.add_argument(
        "--method",
        default=None,
        choices=["direct", "pm", "p3m"],
        help="force algorithm: direct = exact O(N^2) all-pairs (the "
        "reference's, nbody3d.js:218-294); pm = particle-mesh FFT solver "
        "(O(N + M^3 log M), grid-smoothed short range — ops/pm.py); "
        "p3m = PM + exact short-range correction (~1e-3 force accuracy "
        "vs direct at near-PM cost — ops/p3m.py)",
    )
    p.add_argument(
        "--pm-grid",
        type=int,
        default=None,
        help="PM/P3M mesh cells per axis (default 128)",
    )
    p.add_argument(
        "--p3m-nbr-k",
        type=int,
        default=None,
        help="P3M short-range neighbor-tile budget (default 32)",
    )
    p.add_argument(
        "--boundary", default=None, choices=["isolated", "periodic"],
        help="isolated = open space (the reference's mode); periodic = "
        "triply-periodic box [0, box-size)^3 — Ewald-class gravity via "
        "the mesh solvers (requires --method pm|p3m and --box-size)",
    )
    p.add_argument(
        "--box-size", type=float, default=None,
        help="periodic box edge length L (with --boundary periodic)",
    )
    p.add_argument(
        "--interlace", dest="mesh_interlace", default=None,
        action="store_true",
        help="interlaced mesh assignment (periodic boundary): companion "
        "half-cell-shifted deposit averaged in k-space — ~5x lower mesh "
        "force error for one extra deposit+FFT (Hockney-Eastwood)",
    )
    p.add_argument(
        "--no-interlace", dest="mesh_interlace", action="store_false",
        help="disable --interlace",
    )
    p.add_argument(
        "--cosmology", default=None, choices=["none", "eds", "lcdm"],
        help="expanding background: eds = comoving coordinates on an "
        "Einstein-de Sitter universe, lcdm = flat ΛCDM (needs "
        "--boundary periodic and a mesh solver; vel stores "
        "w = a^2 dx/dt, dt is cosmic time — ops/expansion.py)",
    )
    p.add_argument(
        "--omega-lambda", type=float, default=None,
        help="Ω_Λ at the start epoch a=1 for --cosmology lcdm "
        "(flat: Ω_m = 1 - Ω_Λ; default 0.7)",
    )
    p.add_argument(
        "--integrator", default=None,
        choices=["verlet", "euler", "yoshida4"],
        help="verlet/euler are the reference semantics; yoshida4 is the "
        "4th-order symplectic composition (3 force evals/step, O(dt^4) "
        "energy error — supports ~10x larger dt at equal drift)",
    )
    p.add_argument("--devices", type=int, default=1, help=">1 shards bodies over a mesh")
    p.add_argument(
        "--strategy", default=None,
        choices=["ring", "gather", "2d"],
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="multi-host: call jax.distributed.initialize() before device "
        "discovery (same SPMD program over DCN; SURVEY §5.8)",
    )


def _config_overrides(args) -> dict:
    """The config fields the user explicitly set on the command line."""
    ov = {}
    if args.dt is not None:
        ov["dt"] = args.dt
    elif args.log_dt is not None:
        ov["dt"] = 10.0 ** args.log_dt
    if args.G is not None:
        ov["G"] = args.G
    elif args.log_G is not None:
        ov["G"] = 10.0 ** args.log_G
    for field, arg in [
        ("seed", args.seed),
        ("backend", args.backend),
        ("method", args.method),
        ("pm_grid", args.pm_grid),
        ("p3m_nbr_k", args.p3m_nbr_k),
        ("boundary", args.boundary),
        ("box_size", args.box_size),
        ("mesh_interlace", args.mesh_interlace),
        ("cosmology", args.cosmology),
        ("omega_lambda", args.omega_lambda),
        ("integrator", args.integrator),
    ]:
        if arg is not None:
            ov[field] = arg
    if getattr(args, "strategy", None) is not None:
        ov["strategy"] = args.strategy
    return ov


def _build_config(args, base=None):
    """Fresh runs: defaults + explicit flags.  Resume: the checkpoint's
    saved config + explicit flags only (pass ``base``)."""
    if getattr(args, "platform", "auto") != "auto":
        # Must happen before the first backend use.
        import jax

        jax.config.update("jax_platforms", args.platform)
    from nbody3d_tpu.config import SimConfig

    config = (base or SimConfig()).replace(**_config_overrides(args))
    if getattr(args, "omega_lambda", None) is not None and config.cosmology != "lcdm":
        # Ω_Λ only parameterizes the flat-ΛCDM background; silently
        # accepting it under eds/none would mask the user's intent.
        raise SystemExit(
            f"--omega-lambda only applies to --cosmology lcdm "
            f"(resolved cosmology is {config.cosmology!r})"
        )
    return config


def _resolved_strategy(args) -> str:
    """The strategy that will actually be in effect: the explicit flag
    wins; otherwise a resumed checkpoint's saved config (resume semantics:
    the checkpoint's config wins unless overridden); otherwise the
    default.  The mesh shape must follow this (2d needs a 2-axis mesh)."""
    if getattr(args, "strategy", None) is not None:
        return args.strategy
    ckpt = getattr(args, "checkpoint", None)
    if ckpt:
        from nbody3d_tpu.utils.checkpoint import peek_config

        saved = peek_config(ckpt)
        if saved is not None:
            return saved.strategy
    from nbody3d_tpu.config import SimConfig

    return SimConfig().strategy


def _build_mesh(args):
    if getattr(args, "distributed", False):
        import jax

        jax.distributed.initialize()
    if args.devices <= 1:
        return None
    if _resolved_strategy(args) == "2d":
        from nbody3d_tpu.parallel.mesh import grid_mesh

        return grid_mesh(n_devices=args.devices)
    from nbody3d_tpu.parallel.mesh import default_mesh

    return default_mesh(args.devices)


def _load_sim(path, args, mesh=None):
    """Resume semantics: the checkpoint's saved config wins except for
    flags the user explicitly set (which includes dt/G stored inside
    reference-JSON files, re-overridden below if given on the CLI)."""
    from nbody3d_tpu.engine import Simulation
    from nbody3d_tpu.utils.checkpoint import peek_config

    config = _build_config(args, base=peek_config(path))
    sim = Simulation.load(path, config, mesh=mesh)
    ov = _config_overrides(args)
    if "dt" in ov:
        sim.dt = ov["dt"]
    if "G" in ov:
        sim.G = ov["G"]
    return sim


def _make_sim(args, config, mesh):
    from nbody3d_tpu.engine import Simulation

    if getattr(args, "checkpoint", None):
        return _load_sim(args.checkpoint, args, mesh)
    kw = {}
    if args.preset == "reference-random":
        # The reference's run-config UI controls (index.html:68-75).
        kw = dict(
            num_galaxies=args.num_galaxies,
            min_bodies=args.min_bodies,
            max_bodies=args.max_bodies,
        )
    elif args.preset in ("uniform-box", "cosmo") and config.box_size > 0:
        kw = dict(box_size=config.box_size)
    if args.preset == "cosmo" and config.cosmology in ("eds", "lcdm"):
        # Seed the EXPANDING box's growing mode (w = f_i H_i psi), not
        # the static Jeans mode — the preset follows the configured
        # physics (EdS: f_i = 1; ΛCDM: the Heath-integral rate).
        kw["velocity"] = config.cosmology
        if config.cosmology == "lcdm":
            kw["omega_lambda"] = config.omega_lambda
    if args.preset == "cosmo" and getattr(args, "spectrum", None):
        kw["spectrum"] = args.spectrum  # power-law | eh98
        if args.box_mpc is not None:
            kw["box_mpc"] = args.box_mpc
    return Simulation.from_preset(args.preset, config, n=args.n, mesh=mesh, **kw)


def cmd_run(args) -> int:
    import contextlib

    config = _build_config(args)
    mesh = _build_mesh(args)
    sim = _make_sim(args, config, mesh)
    os.makedirs(args.outdir, exist_ok=True)
    if args.metrics:
        sim.metrics_path = args.metrics

    trace_cm = contextlib.nullcontext()
    if args.trace:
        from nbody3d_tpu.utils.profiling import device_trace

        trace_cm = device_trace(args.trace)
    with trace_cm:
        return _run_loop(args, sim)


def _run_loop(args, sim) -> int:
    chunk = args.log_every
    done = 0
    next_ckpt = args.checkpoint_every or 0
    next_frame = args.render_every or 0
    next_analysis = args.analyze_every or 0
    frame_idx = 0
    if args.render_every:
        from nbody3d_tpu.render.image import save_png

        save_png(os.path.join(args.outdir, f"frame_{frame_idx:06d}.png"), sim.render_frame())
        frame_idx += 1
    while done < args.steps:
        k = min(chunk, args.steps - done)
        sim.run(k, chunk=k)
        done += k
        for line in sim.log_lines():
            print(line, flush=True)
        if args.diagnostics:
            d = sim.diagnostics()
            print(
                f"  E={float(d.total_energy):.6e} KE={float(d.kinetic):.6e} "
                f"PE={float(d.potential):.6e} |P|={float(np.linalg.norm(d.momentum)):.3e}",
                flush=True,
            )
        if args.checkpoint_every and done >= next_ckpt:
            path = os.path.join(args.outdir, f"ckpt_{sim.step_count:08d}.npz")
            sim.save(path)
            print(f"  checkpoint -> {path}", flush=True)
            next_ckpt += args.checkpoint_every
        if args.analyze_every and done >= next_analysis:
            from nbody3d_tpu import analysis

            pm_a, v_a, _ = sim.arrays()
            s = analysis.summary(
                pm_a, v_a, sim.G, eps2=sim.config.eps2,
                nbins=16, potential=False,
            )
            s["step"] = sim.step_count
            with open(os.path.join(args.outdir, "analysis.jsonl"), "a") as f:
                f.write(json.dumps(s) + "\n")
            lr = s["lagrangian_radii"]
            print(
                f"  r10={lr['r10']:.4g} r50={lr['r50']:.4g} "
                f"r90={lr['r90']:.4g} "
                f"sigma_c={s['velocity_dispersion'][0]:.4g}",
                flush=True,
            )
            next_analysis += args.analyze_every
        if args.render_every and done >= next_frame:
            from nbody3d_tpu.render.image import save_png

            path = os.path.join(args.outdir, f"frame_{frame_idx:06d}.png")
            save_png(path, sim.render_frame())
            print(f"  frame -> {path}", flush=True)
            frame_idx += 1
            next_frame += args.render_every
    sim.save(os.path.join(args.outdir, "final.npz"))
    return 0


def cmd_bench(args) -> int:
    config = _build_config(args)
    mesh = _build_mesh(args)
    from nbody3d_tpu.engine import Simulation

    if args.steps % args.chunk != 0:
        raise SystemExit(
            f"bench: --steps ({args.steps}) must be a multiple of --chunk "
            f"({args.chunk}) — a trailing partial chunk would compile a new "
            f"scan inside the timed region and skew the result"
        )
    sim = Simulation.from_preset(args.preset, config, n=args.n, mesh=mesh)
    # Warmup must use the SAME chunk length as the timed run (scan compiles
    # per static chunk length).
    sim.run(max(args.warmup_steps, args.chunk), chunk=args.chunk)
    t0 = time.perf_counter()
    sim.run(args.steps, chunk=args.chunk)
    elapsed = time.perf_counter() - t0
    steps_per_s = args.steps / elapsed
    gints = sim.pair_interactions_per_step * steps_per_s / 1e9
    out = {
        "n_bodies": sim.n_real,
        "n_pad": sim.n_pad,
        "steps": args.steps,
        "elapsed_s": elapsed,
        "steps_per_s": steps_per_s,
        "gints_per_s": gints,
        "backend": config.backend,
        "devices": args.devices,
    }
    print(json.dumps(out))
    return 0


def cmd_render(args) -> int:
    _build_config(args)  # applies --platform before backend use
    from nbody3d_tpu.render.image import save_png

    sim = _load_sim(args.checkpoint, args)
    img = sim.render_frame(width=args.width, height=args.height,
                           color_mode=args.color_mode, resolve=args.resolve)
    save_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_convert(args) -> int:
    _build_config(args)  # applies --platform before backend use

    sim = _load_sim(args.input, args)
    sim.save(args.output)
    print(f"{args.input} -> {args.output} (N={sim.n_real}, step={sim.step_count})")
    return 0


def cmd_analyze(args) -> int:
    """Physics analysis report of a checkpoint (nbody3d_tpu.analysis):
    COM frame, conservation vector norms, Lagrangian radii, density and
    velocity-dispersion profiles, virial ratio.  The quantitative
    counterpart of eyeballing the reference's canvas."""
    import json as _json

    _build_config(args)  # applies --platform before backend use
    from nbody3d_tpu import analysis

    sim = _load_sim(args.checkpoint, args)
    # Device-resident analysis: the structural statistics and the power
    # spectrum are jnp end to end, so at viewer scale (N=16M) nothing
    # per-body leaves the device for them; FoF streams quantized
    # positions (~10 B/body, analysis.quantize_for_fof) instead of the
    # 270 MB of f32 state.
    n = sim.n_real
    pos_mass = sim.state.pos_mass[:n]
    vel = sim.state.vel[:n]
    stream = args.fof_stream == "always" or (
        args.fof_stream == "auto" and n >= (1 << 22)
    )
    pe = args.pe == "exact" or (args.pe == "auto" and n <= 131072)
    s = analysis.summary(
        pos_mass, vel, sim.config.G, eps2=sim.config.eps2,
        nbins=args.bins, potential=pe, pe_chunk=args.pe_chunk,
    )
    s["step"] = sim.step_count
    if args.fof:
        box = (
            sim.config.box_size
            if sim.config.boundary == "periodic"
            else None
        )
        if stream:
            labels, ll, pm_cat = analysis.fof_groups_streamed(
                pos_mass, args.linking_length or None, box_size=box
            )
            vel_cat = None  # vcom omitted: velocities never fetched
        else:
            import jax as _jax

            pm_cat, vel_cat = _jax.device_get((pos_mass, vel))
            labels, ll = analysis.fof_groups(
                pm_cat, args.linking_length or None, box_size=box
            )
        cat = analysis.group_catalog(
            pm_cat, vel_cat, labels,
            min_size=args.fof_min_size, box_size=box,
        )
        s["fof"] = {
            "linking_length": ll,
            "min_size": args.fof_min_size,
            "streamed": bool(stream),
            "n_groups": len(cat),
            "grouped_fraction": float(
                sum(g["n"] for g in cat) / max(n, 1)
            ),
            "groups": cat[:50],
        }
    if args.power_spectrum:
        box = (
            sim.config.box_size
            if sim.config.boundary == "periodic"
            else None
        )
        k, p, cnt = analysis.power_spectrum(
            pos_mass, grid=args.power_spectrum, box_size=box
        )
        if box is not None:
            vol = float(box) ** 3
        else:
            # the measurement box the autobox used: Nyquist pins grid/L
            vol = (args.power_spectrum * 3.14159265 / float(k[-1] + k[0])) ** 3
        s["power_spectrum"] = {
            "k": [float(x) for x in k],
            "P": [float(x) for x in p],
            "n_modes": [float(x) for x in cnt],
            "shot_noise": float(analysis.shot_noise(pos_mass, vol)),
        }
    if args.ps_out:
        if "power_spectrum" not in s:
            print("--ps-out requires --power-spectrum GRID", file=sys.stderr)
            return 2
        ps = s["power_spectrum"]
        with open(args.ps_out, "w") as f:
            f.write("k,P,n_modes\n")
            for k_i, p_i, c_i in zip(ps["k"], ps["P"], ps["n_modes"]):
                f.write(f"{k_i:.8g},{p_i:.8g},{c_i:.0f}\n")
        print(f"wrote {args.ps_out}")
    if args.profile:
        edges = s["density_profile"]["edges"]
        with open(args.profile, "w") as f:
            f.write("r_lo,r_hi,rho,count,sigma_v\n")
            for i in range(args.bins):
                f.write(
                    f"{edges[i]:.8g},{edges[i + 1]:.8g},"
                    f"{s['density_profile']['rho'][i]:.8g},"
                    f"{s['density_profile']['count'][i]:.0f},"
                    f"{s['velocity_dispersion'][i]:.8g}\n"
                )
        print(f"wrote {args.profile}")
    if args.json:
        print(_json.dumps(s))
    else:
        print(f"step               {sim.step_count}")
        print(analysis.format_report(s))
        if "fof" in s:
            f = s["fof"]
            print(
                f"fof groups         {f['n_groups']} (>= {f['min_size']} "
                f"bodies, b={f['linking_length']:.4g}, "
                f"{100 * f['grouped_fraction']:.1f}% of mass-carrying bodies)"
            )
            for g in f["groups"][:5]:
                com = " ".join(f"{x:.4g}" for x in g["com"])
                print(
                    f"  n={g['n']:<8,} mass={g['mass']:.4g}  "
                    f"com=[{com}]  rmax={g['rmax']:.4g}"
                )
        if "power_spectrum" in s:
            ps = s["power_spectrum"]
            occupied = [
                (k_i, p_i) for k_i, p_i, c_i
                in zip(ps["k"], ps["P"], ps["n_modes"]) if c_i > 0
            ]
            lo_k, lo_p = occupied[0]
            hi_k, hi_p = occupied[-1]
            print(
                f"power spectrum     P({lo_k:.4g})={lo_p:.4g}  "
                f"P({hi_k:.4g})={hi_p:.4g}  "
                f"shot noise {ps['shot_noise']:.4g}"
            )
        if not pe:
            print("(potential/virial skipped at this N; --pe exact to force)")
    return 0


def cmd_animate(args) -> int:
    """Frame sequence with a scripted orbital camera — the headless stand-in
    for the reference's interactive orbit (camera.js:143-168), optionally
    advancing physics between frames (the decoupled frame loop)."""
    import math as _math

    _build_config(args)  # applies --platform before backend use
    from nbody3d_tpu.render.image import save_png
    from nbody3d_tpu.utils.camera import ROT_SPEED, Camera

    sim = _load_sim(args.checkpoint, args)
    cam = Camera(target=sim.camera_target)
    os.makedirs(args.outdir, exist_ok=True)
    step_px = _math.radians(args.orbit_degrees) / max(args.frames, 1) / ROT_SPEED
    frame_paths = []
    for i in range(args.frames):
        img = sim.render_frame(camera=cam, width=args.width, height=args.height)
        path = os.path.join(args.outdir, f"frame_{i:06d}.png")
        save_png(path, img)
        frame_paths.append(path)
        cam.orbit(step_px, 0.0)
        if args.steps_per_frame:
            sim.run(args.steps_per_frame, chunk=args.steps_per_frame)
    print(f"wrote {args.frames} frames to {args.outdir}")
    if args.video:
        from nbody3d_tpu.render.image import save_animation

        save_animation(frame_paths, args.video, fps=args.fps)
        print(f"wrote {args.video}")
    return 0


def cmd_serve(args) -> int:
    """Live interactive viewer — the reference's browser experience
    (render loop + sliders + camera interaction + HUD) served over HTTP
    while the accelerator advances the simulation (viewer.py)."""
    config = _build_config(args)
    mesh = _build_mesh(args)
    from nbody3d_tpu.engine import Simulation
    from nbody3d_tpu.viewer import LiveViewer

    if args.checkpoint:
        sim = _load_sim(args.checkpoint, args, mesh)
    else:
        sim = Simulation.from_preset(args.preset, config, n=args.n, mesh=mesh)
    viewer = LiveViewer(
        sim,
        width=args.width,
        height=args.height,
        steps_per_frame=args.steps_per_frame,
        diagnostics_every=args.diagnostics_every,
        resolve=args.resolve,
    )
    viewer.serve_forever(args.host, args.port)
    return 0


def cmd_info(args) -> int:
    from nbody3d_tpu.parallel.mesh import mesh_info

    print(json.dumps(mesh_info(), indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nbody3d-tpu", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    p.add_argument("--preset", default="two-galaxy")
    p.add_argument("--checkpoint", default=None, help="resume from checkpoint instead of preset")
    p.add_argument("--n", type=int, default=None, help="body count override")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--analyze-every", type=int, default=0,
                   help="append a structural-analysis record (Lagrangian "
                        "radii, central dispersion — O(N log N) terms only) "
                        "to <outdir>/analysis.jsonl every K steps")
    p.add_argument("--diagnostics", action="store_true")
    p.add_argument("--outdir", default="out")
    p.add_argument("--metrics", default=None, help="append JSONL metrics to this file")
    p.add_argument("--trace", default=None, help="dump a jax.profiler trace to this dir")
    # reference-random preset controls (index.html:68-75 defaults)
    p.add_argument("--num-galaxies", type=int, default=2)
    p.add_argument("--min-bodies", type=int, default=20000)
    p.add_argument("--max-bodies", type=int, default=20000)
    # cosmo preset: initial power spectrum
    p.add_argument("--spectrum", default=None,
                   choices=["power-law", "eh98"],
                   help="cosmo preset P(k): power-law (default) or the "
                        "Eisenstein-Hu 1998 flat-ΛCDM transfer function "
                        "(Ωm = 1 - omega_lambda; box mapped to --box-mpc "
                        "h⁻¹Mpc of comoving space)")
    p.add_argument("--box-mpc", type=float, default=None,
                   help="physical size the cosmo box represents for "
                        "--spectrum eh98 (default 100 h⁻¹Mpc)")
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("animate", help="orbiting-camera frame sequence from a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--orbit-degrees", type=float, default=360.0)
    p.add_argument("--steps-per-frame", type=int, default=0,
                   help="advance the simulation between frames (0 = camera-only)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--outdir", default="frames")
    p.add_argument("--video", default=None,
                   help="also assemble frames into this file (.gif always "
                        "works; .mp4/.webm need ffmpeg on PATH)")
    p.add_argument("--fps", type=float, default=30.0)
    _add_common(p)
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    p.add_argument("--preset", default="uniform-sphere")
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup-steps", type=int, default=3)
    p.add_argument("--chunk", type=int, default=10)
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("render", help="render a checkpoint to PNG")
    p.add_argument("checkpoint")
    p.add_argument("-o", "--output", default="frame.png")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--color-mode", default="magnitude", choices=["magnitude", "direction"],
                   help="velocity magnitude colormap (nbody3d.js:380) or direction (:381)")
    p.add_argument("--resolve", default="auto",
                   choices=["auto", "native", "numpy", "device"],
                   help="depth-resolve path; 'device' rasterizes on the "
                        "accelerator via a quantized scatter-min and fetches "
                        "only the framebuffer, not 20 B/body (the 16M-body "
                        "mode)")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("analyze", help="physics analysis report of a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--bins", type=int, default=64,
                   help="radial bins for the density/dispersion profiles")
    p.add_argument("--pe", default="auto", choices=["auto", "exact", "skip"],
                   help="O(N^2) potential/virial terms: auto skips above "
                        "128k bodies")
    p.add_argument("--pe-chunk", type=int, default=1024)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--profile", default="",
                   help="also write the radial profiles as CSV to this path")
    p.add_argument("--fof", action="store_true",
                   help="friends-of-friends group catalog (native union-find "
                        "core; periodic runs link across the torus seam)")
    p.add_argument("--linking-length", type=float, default=0.0,
                   help="FOF linking length (default 0 = 0.2x the mean "
                        "interparticle separation)")
    p.add_argument("--fof-min-size", type=int, default=20,
                   help="drop FOF groups below this many members")
    p.add_argument("--fof-stream", default="auto",
                   choices=["auto", "always", "never"],
                   help="stream device-quantized positions to the host "
                        "FOF (~10 B/body instead of 16; pair decisions "
                        "within ~0.1%% of the linking length may flip — "
                        "analysis.quantize_for_fof).  auto = on from 4M "
                        "bodies; vcom is omitted from the catalog "
                        "(velocities never leave the device)")
    p.add_argument("--power-spectrum", type=int, default=0, metavar="GRID",
                   help="measure the mass density power spectrum P(k) on a "
                        "GRID^3 CIC mesh (periodic runs use the torus box; "
                        "isolated runs the massive bodies' bounding cube)")
    p.add_argument("--ps-out", default="",
                   help="write the P(k) table as CSV to this path")
    _add_common(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("convert", help="convert checkpoint formats (.json <-> .npz)")
    p.add_argument("input")
    p.add_argument("output")
    _add_common(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "serve", help="live interactive viewer over HTTP (MJPEG + controls)"
    )
    p.add_argument("--checkpoint", default=None, help="resume from a checkpoint")
    p.add_argument("--preset", default="two-galaxy")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--steps-per-frame", type=int, default=20)
    p.add_argument("--diagnostics-every", type=int, default=0,
                   help="compute total energy every this many frames (0 = off)")
    p.add_argument("--resolve", default="auto",
                   choices=["auto", "native", "numpy", "device"],
                   help="depth-resolve path; 'device' keeps per-body data on "
                        "the accelerator (large-N live viewing)")
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("info", help="platform / device report")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from nbody3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
