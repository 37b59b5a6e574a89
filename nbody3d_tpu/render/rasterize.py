"""Point-splat rasterizer: circles with depth test, one per body.

Reference semantics rebuilt (``nbody3d.js:313-415``):

- world radius from mass: ``(m / 4.189)^(1/3)`` — unit-density sphere
  (``nbody3d.js:346``), with the minimum apparent-size clamp
  ``max(radius, 2 * |viewVec| / f)`` that keeps far particles ~2px
  (``nbody3d.js:358``), all scaled by ``sizeRatio = 1/sizeFactor``
  (``camera.js:61``);
- camera-facing billboard + circle-SDF discard (``nbody3d.js:354-358,
  377-378``) → a screen-space disc of the projected billboard radius;
- color by velocity magnitude (``nbody3d.js:380``);
- depth-tested with 'less' (``nbody3d.js:401-405``), black clear color
  (``nbody3d.js:421``).
- WebGPU clips ``0 <= z_clip <= w`` while the reference uses a GL-style
  projection matrix mapping [near, far] -> z_ndc in [-1, 1]
  (``matrix.js:106-129``); the net effect — an effective near plane at
  ~2·near·far/(near+far) — is reproduced here for parity
  (see utils.mathlib.perspective).

Implementation: vectorized numpy.  Depth resolve is a single deterministic
scatter-min of packed ``(depth_bits << 32) | rgb24`` uint64 keys — IEEE
non-negative floats order like their bit patterns, so minimum-by-key is the
depth test, with ties broken by color for full determinism (the reference's
GPU rasterization order is unspecified for coincident depths).  Work is
proportional to total splat area: bodies are sorted by radius so each stamp
offset only touches bodies large enough to cover it.  The renderer is off
the hot path by design (SURVEY P3): correctness and determinism over
throughput.
"""

from __future__ import annotations

import math

import numpy as np

from nbody3d_tpu.render.colormap import direction_colormap, velocity_colormap
from nbody3d_tpu.utils import mathlib
from nbody3d_tpu.utils.camera import Camera


def project_points(
    pos: np.ndarray,
    camera: Camera,
    width: int,
    height: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Project world positions. Returns (px, py, depth01, view_depth).

    ``depth01`` is the WebGPU depth-buffer value z_clip/w in [0, 1];
    ``view_depth`` is the positive view-space distance along the camera
    axis (used for apparent-size math).
    """
    aspect = width / height
    vp, _f = camera.view_proj(aspect)
    n = pos.shape[0]
    homo = np.concatenate([pos, np.ones((n, 1), dtype=pos.dtype)], axis=1)
    clip = homo @ vp.T  # (N, 4)
    w = clip[:, 3]
    safe_w = np.where(np.abs(w) < 1e-30, 1e-30, w)
    ndc = clip[:, :3] / safe_w[:, None]
    px = (ndc[:, 0] + 1.0) * 0.5 * width
    py = (1.0 - ndc[:, 1]) * 0.5 * height
    depth01 = clip[:, 2] / safe_w  # WebGPU z in [0,1] visible range
    return px, py, depth01, w  # w_clip == view-space distance for this proj


# Radius (px) above which a splat is rasterized per-body instead of via
# the shared offset loop; the loop then runs <= (2*_SMALL_MAX+1)^2 passes.
_SMALL_MAX = 6
_d2_grids: dict[int, np.ndarray] = {}


def _d2_grid(ri: int) -> np.ndarray:
    g = _d2_grids.get(ri)
    if g is None:
        a = np.arange(-ri, ri + 1, dtype=np.float64)
        g = a[:, None] ** 2 + a[None, :] ** 2
        _d2_grids[ri] = g
    return g


def _stamp_disc(buf2d, cx, cy, r, key, h, w) -> None:
    """Depth-min a filled circle into the packed-key buffer (one body).
    Inclusion is exactly |offset| <= r, matching the shared offset loop."""
    ri = int(math.floor(r))
    mask = _d2_grid(ri) <= r * r
    y0, y1 = cy - ri, cy + ri + 1
    x0, x1 = cx - ri, cx + ri + 1
    my0, mx0 = max(0, -y0), max(0, -x0)
    y0, x0 = max(0, y0), max(0, x0)
    y1, x1 = min(h, y1), min(w, x1)
    if y0 >= y1 or x0 >= x1:
        return
    sub = buf2d[y0:y1, x0:x1]
    m = mask[my0 : my0 + (y1 - y0), mx0 : mx0 + (x1 - x0)]
    np.minimum(sub, np.where(m, key, np.uint64(0xFFFFFFFFFFFFFFFF)), out=sub)


def _prep_host(pos_mass, vel, camera, width, height, size_factor,
               max_radius_px, color_mode):
    """Host (numpy, f64) projection/radius/color prep.  Returns
    ``(cx, cy, keys, r)`` sorted by radius descending, visible bodies
    only — the resolve inputs."""
    pos = np.asarray(pos_mass, dtype=np.float64)[:, :3]
    mass = np.asarray(pos_mass, dtype=np.float64)[:, 3]
    vel3 = np.asarray(vel, dtype=np.float64)[:, :3]

    aspect = width / height
    _vp, f = camera.view_proj(aspect)
    px, py, depth01, view_w = project_points(pos, camera, width, height)

    # World-space billboard half-extent (nbody3d.js:346,358; camera.js:61).
    view_vec_len = np.linalg.norm(pos - camera.position[None, :], axis=1)
    radius_world = np.cbrt(mass / 4.189)
    half_extent = np.maximum(radius_world, 2.0 * view_vec_len / f) / size_factor

    # Projected pixel radius: perpendicular world length L at view depth d
    # spans L * f / d in NDC y, i.e. L * f / d * H/2 pixels.
    safe_d = np.maximum(view_w, 1e-30)
    r_px = half_extent * f / safe_d * (height * 0.5)

    visible = (view_w > 0) & (depth01 >= 0.0) & (depth01 <= 1.0)
    r_px = np.clip(r_px, 0.5, max_radius_px)
    visible &= (px + r_px >= 0) & (px - r_px < width)
    visible &= (py + r_px >= 0) & (py - r_px < height)

    idx = np.nonzero(visible)[0]
    if idx.size == 0:
        return (np.empty(0, np.int64),) * 2 + (
            np.empty(0, np.uint64), np.empty(0, np.float64),
        )

    if color_mode == "direction":
        rgb = (direction_colormap(vel3[idx]) * 255.0).astype(np.uint32)
    else:
        speed = np.linalg.norm(vel3[idx], axis=1)
        rgb = (velocity_colormap(speed) * 255.0).astype(np.uint32)
    rgb24 = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]

    cx = np.round(px[idx]).astype(np.int64)
    cy = np.round(py[idx]).astype(np.int64)
    depth = depth01[idx].astype(np.float32)
    keys = (np.ascontiguousarray(depth).view(np.uint32).astype(np.uint64) << 32) | rgb24

    # Sort by radius (desc) so stamp offset (dx,dy) only visits the first k
    # bodies with r >= |offset|.
    r = r_px[idx]
    order = np.argsort(-r, kind="stable")
    return cx[order], cy[order], keys[order], r[order]


# Below this many bodies the host (f64 numpy) prep is used; above it the
# projection/radius/colormap/sort run on the accelerator (f32 jnp) and only
# the stamp loop stays on host — at 16M bodies the host prep alone (f64
# matmul + argsort + colormap over 16M rows) costs tens of seconds
#.
_DEVICE_PREP_MIN = 1 << 20


def _project_f32(pos_mass, vel, vp, f, campos, size_factor, width, height,
                 max_radius_px, color_mode):
    """The device prep's projection math (same as :func:`_prep_host` in
    f32), traced inside either prep jit.  Returns per-body ``(cx, cy,
    depth_bits, rgb24, r_px, visible)`` in INPUT order."""
    import jax
    import jax.numpy as jnp

    pos = pos_mass[:, :3]
    mass = pos_mass[:, 3]
    n = pos.shape[0]
    homo = jnp.concatenate([pos, jnp.ones((n, 1), jnp.float32)], axis=1)
    clip = jnp.matmul(homo, vp.T, precision=jax.lax.Precision.HIGHEST)
    w = clip[:, 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-30, 1e-30, w)
    ndc_x = clip[:, 0] / safe_w
    ndc_y = clip[:, 1] / safe_w
    depth01 = clip[:, 2] / safe_w
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height
    view_vec_len = jnp.linalg.norm(pos - campos[None, :], axis=1)
    radius_world = jnp.cbrt(mass / 4.189)
    half_extent = jnp.maximum(radius_world, 2.0 * view_vec_len / f) / size_factor
    r_px = half_extent * f / jnp.maximum(w, 1e-30) * (height * 0.5)
    r_px = jnp.clip(r_px, 0.5, max_radius_px)
    visible = (w > 0) & (depth01 >= 0.0) & (depth01 <= 1.0)
    visible &= (px + r_px >= 0) & (px - r_px < width)
    visible &= (py + r_px >= 0) & (py - r_px < height)

    if color_mode == "direction":
        v3 = vel[:, :3]
        norm = jnp.linalg.norm(v3, axis=1, keepdims=True)
        unit = jnp.where(norm > 0, v3 / jnp.maximum(norm, 1e-30), 0.0)
        rgbf = jnp.clip(unit * 0.5 + 0.5, 0.0, 1.0)
    else:
        v = jnp.linalg.norm(vel[:, :3], axis=1) / 40.0  # nbody3d.js:380
        rgbf = jnp.clip(
            jnp.stack([v, 1.0 - jnp.abs(v - 0.5), 1.0 - v], axis=1),
            0.0, 1.0,
        )
    rgb = (rgbf * 255.0).astype(jnp.uint32)
    rgb24 = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    depth_bits = jax.lax.bitcast_convert_type(
        jnp.clip(depth01, 0.0, 1.0), jnp.uint32
    )
    return (
        jnp.round(px).astype(jnp.int32),
        jnp.round(py).astype(jnp.int32),
        depth_bits, rgb24, r_px, visible,
    )


def _prep_device_jit():
    """Build (once) the jitted device prep: same math as :func:`_prep_host`
    in f32, returning radius-sorted resolve inputs + the visible count."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(
        jax.jit,
        static_argnames=("width", "height", "max_radius_px", "color_mode"),
    )
    def prep(pos_mass, vel, vp, f, campos, size_factor, *, width, height,
             max_radius_px, color_mode):
        cx, cy, depth_bits, rgb24, r_px, visible = _project_f32(
            pos_mass, vel, vp, f, campos, size_factor,
            width, height, max_radius_px, color_mode,
        )
        sortkey = jnp.where(visible, -r_px, jnp.float32(jnp.inf))
        order = jnp.argsort(sortkey, stable=True)
        return (
            cx[order], cy[order], depth_bits[order], rgb24[order],
            r_px[order], jnp.sum(visible),
        )

    return prep


_prep_device_cache = []


def _prep_device_raw(pos_mass, vel, camera, width, height, size_factor,
                     max_radius_px, color_mode):
    """Run the jitted device prep; returns the ON-DEVICE sorted arrays
    ``(cx, cy, depth_bits, rgb24, r, nvis)`` (radius-descending, visible
    bodies first)."""
    import jax.numpy as jnp

    if not _prep_device_cache:
        _prep_device_cache.append(_prep_device_jit())
    prep = _prep_device_cache[0]
    aspect = width / height
    vp, f = camera.view_proj(aspect)
    return prep(
        jnp.asarray(pos_mass, jnp.float32),
        jnp.asarray(vel, jnp.float32),
        jnp.asarray(vp, jnp.float32),
        jnp.float32(f),
        jnp.asarray(camera.position, jnp.float32),
        jnp.float32(size_factor),
        width=width, height=height,
        max_radius_px=max_radius_px, color_mode=color_mode,
    )


def _prep_device(pos_mass, vel, camera, width, height, size_factor,
                 max_radius_px, color_mode):
    """Device (jnp, f32) prep — same contract as :func:`_prep_host`."""
    import jax

    out = _prep_device_raw(pos_mass, vel, camera, width, height,
                           size_factor, max_radius_px, color_mode)
    cx, cy, depth_bits, rgb24, r, nvis = map(np.asarray, jax.device_get(out))
    k = int(nvis)
    keys = (depth_bits[:k].astype(np.uint64) << 32) | rgb24[:k]
    return cx[:k].astype(np.int64), cy[:k].astype(np.int64), keys, r[:k]


# --- Device resolve -------------------------------------------------------
#
# The host resolve needs the per-body arrays on the host: ~20 B/body of
# device->host traffic.  The device resolve rasterizes the SMALL splats (r < 2 px — the bulk at viewer
# scale) on the accelerator with one scatter-min per stamp offset into a
# (H*W,) uint32 buffer, so the host only fetches the framebuffer
# (8 MB at 1080p) plus the few large splats (prefix of the
# radius-descending sort), which keep full stamp semantics on the host.
# This is SURVEY §7 hard-part 5's "sort by pixel id / scatter" design.
#
# Precision contract (vs the exact host resolve): the scatter value is
# depth16 << 16 | rgb565 — 16-bit depth test, 5/6/5 color.  Depth ties
# within 2^-16 of the [0,1] depth range may pick a different (still
# deterministic: min over color bits) winner; colors quantize to
# rgb565 and decode by bit replication (<= 4/255 per channel).

# Stamp offsets covering every splat with r < 2 px (inclusion is
# |offset| <= r and the largest needed offset is |(1,1)| = 1.415).
_DEVICE_OFFSETS = [
    (0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (1, -1), (-1, 1), (-1, -1),
]
_DEVICE_RESOLVE_RMAX = 2.0
_EMPTY32 = 0xFFFFFFFF  # depth16 sentinel: real depths are <= 0x3F80....


def _rgb565_device(rgb24):
    import jax.numpy as jnp

    r = (rgb24 >> jnp.uint32(19)) & jnp.uint32(0x1F)
    g = (rgb24 >> jnp.uint32(10)) & jnp.uint32(0x3F)
    b = (rgb24 >> jnp.uint32(3)) & jnp.uint32(0x1F)
    return (r << jnp.uint32(11)) | (g << jnp.uint32(5)) | b


def _rgb565_host(rgb24: np.ndarray) -> np.ndarray:
    rgb24 = rgb24.astype(np.uint32)
    r = (rgb24 >> 19) & 0x1F
    g = (rgb24 >> 10) & 0x3F
    b = (rgb24 >> 3) & 0x1F
    return (r << 11) | (g << 5) | b


def _decode565(v: np.ndarray) -> np.ndarray:
    """(K,) uint16 rgb565 -> (K, 3) uint8 by bit replication."""
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    return np.stack(
        [(r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)],
        axis=-1,
    ).astype(np.uint8)


def _scatter_resolve_jit():
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("width", "height"))
    def resolve(cx, cy, depth_bits, rgb24, r, nvis, *, width, height):
        n = cx.shape[0]
        valid = jnp.arange(n) < nvis
        small = valid & (r < _DEVICE_RESOLVE_RMAX)
        value = ((depth_bits >> jnp.uint32(16)) << jnp.uint32(16)) | (
            _rgb565_device(rgb24)
        )
        buf = jnp.full(width * height, jnp.uint32(_EMPTY32))
        for dx, dy in _DEVICE_OFFSETS:
            need = math.hypot(dx, dy)
            m = small if need == 0.0 else small & (r >= jnp.float32(need))
            x = cx + dx
            y = cy + dy
            m = m & (x >= 0) & (x < width) & (y >= 0) & (y < height)
            idx = jnp.where(m, y * width + x, width * height)  # OOB -> drop
            buf = buf.at[idx].min(value, mode="drop")
        n_large = jnp.sum(valid & (r >= _DEVICE_RESOLVE_RMAX))
        return buf, n_large

    return resolve


_scatter_resolve_cache = []


def _scatter_resolve(cx, cy, depth_bits, rgb24, r, nvis, *, width, height):
    if not _scatter_resolve_cache:
        _scatter_resolve_cache.append(_scatter_resolve_jit())
    return _scatter_resolve_cache[0](
        cx, cy, depth_bits, rgb24, r, nvis, width=width, height=height
    )


def device_resolve_begin(pos_mass, vel, camera, *, width, height,
                         size_factor=1000.0, max_radius_px=64,
                         color_mode="magnitude"):
    """Dispatch the device half of a device-resolve frame (projection,
    radius sort, small-splat scatter-min) without waiting for it.  Returns
    a handle for :func:`device_resolve_finish`; its arrays are fresh
    device buffers, so the state may be donated to a physics chunk in
    between (the pipelined serve loop)."""
    cx, cy, depth_bits, rgb24, r, nvis = _prep_device_raw(
        pos_mass, vel, camera, width, height, size_factor, max_radius_px,
        color_mode,
    )
    buf, n_large = _scatter_resolve(
        cx, cy, depth_bits, rgb24, r, nvis, width=width, height=height
    )
    return {
        "buf": buf, "splats": (cx, cy, depth_bits, rgb24, r),
        "n_large": n_large, "size": (width, height),
    }


def composite_device_frame(buf, large, width, height, background=(0, 0, 0)):
    """Host half of the device resolve: stamp the large splats (host
    arrays ``(cx, cy, depth_bits, rgb24, r)`` with r >= 2 px) into the
    fetched (H*W,) uint32 depth16|rgb565 framebuffer with full disc
    semantics, and decode it into an (H, W, 3) uint8 image."""
    buf = np.asarray(buf).astype(np.uint64)
    cx, cy, depth_bits, rgb24, r = (np.asarray(a) for a in large)
    k = cx.shape[0]
    if k:
        keys = (((depth_bits.astype(np.uint64) >> 16) << 16)
                | _rgb565_host(rgb24))
        from nbody3d_tpu import native

        if native.raster is not None:
            native.raster.stamp_discs(
                buf, height, width,
                np.ascontiguousarray(cx.astype(np.int64)),
                np.ascontiguousarray(cy.astype(np.int64)),
                np.ascontiguousarray(r.astype(np.float64)),
                np.ascontiguousarray(keys),
            )
        else:
            buf2d = buf.reshape(height, width)
            for i in range(k):
                _stamp_disc(buf2d, int(cx[i]), int(cy[i]), float(r[i]),
                            keys[i], height, width)

    img = np.empty((height, width, 3), dtype=np.uint8)
    img[:] = np.asarray(background, dtype=np.uint8)
    hit = buf != np.uint64(_EMPTY32)
    img.reshape(-1, 3)[hit] = _decode565(
        (buf[hit] & np.uint64(0xFFFF)).astype(np.uint16)
    )
    return img


def device_resolve_finish(handle, background=(0, 0, 0)):
    """Fetch a :func:`device_resolve_begin` frame and composite it.  Large
    splats are the prefix of the radius-descending sort: only those rows
    leave the device."""
    import jax

    width, height = handle["size"]
    k = int(jax.device_get(handle["n_large"]))
    large = jax.device_get(tuple(a[:k] for a in handle["splats"]))
    return composite_device_frame(
        jax.device_get(handle["buf"]), large, width, height, background
    )


def render_points(
    pos_mass: np.ndarray,
    vel: np.ndarray,
    camera: Camera,
    *,
    width: int = 1024,
    height: int = 768,
    size_factor: float = 1000.0,
    max_radius_px: int = 64,
    background: tuple[int, int, int] = (0, 0, 0),
    color_mode: str = "magnitude",
    prep: str = "auto",
    resolve: str = "auto",
) -> np.ndarray:
    """Render one frame. Returns (H, W, 3) uint8.

    ``color_mode``: "magnitude" (``nbody3d.js:380``) or "direction" (the
    reference's alternate visualization, ``nbody3d.js:381``).
    ``prep``: "host" (f64 numpy — bit-stable golden path), "device" (f32
    jnp projection/color/sort on the accelerator — viewer-scale N), or
    "auto" (device above ``_DEVICE_PREP_MIN`` bodies).
    ``resolve``: "native" (C stamp loop), "numpy", or "auto" (native when
    the compiled module is available) — bit-identical either way — or
    "device": the on-accelerator scatter-min that shrinks the
    device→host readback from ~20 B/body to the framebuffer itself
    (16-bit depth / rgb565 color contract — see the device-resolve block
    above).
    """
    if resolve == "device":
        return device_resolve_finish(
            device_resolve_begin(
                pos_mass, vel, camera, width=width, height=height,
                size_factor=size_factor, max_radius_px=max_radius_px,
                color_mode=color_mode,
            ),
            background,
        )
    if prep == "auto":
        prep = "device" if pos_mass.shape[0] >= _DEVICE_PREP_MIN else "host"
    prep_fn = _prep_device if prep == "device" else _prep_host
    cx, cy, keys, r = prep_fn(
        pos_mass, vel, camera, width, height, size_factor,
        max_radius_px, color_mode,
    )

    h, w_ = height, width
    img = np.empty((h, w_, 3), dtype=np.uint8)
    img[:] = np.asarray(background, dtype=np.uint8)
    if cx.size == 0:
        return img

    buf = np.full(h * w_, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)

    from nbody3d_tpu import native

    use_native = (
        native.raster is not None if resolve == "auto" else resolve == "native"
    )
    if use_native:
        if native.raster is None:
            raise RuntimeError("native raster resolve unavailable (no compiler)")
        # Native resolve (native/_raster.c): one row-span stamp loop over
        # all bodies, work exactly the total splat area; min-by-key is
        # order-independent so the output is bit-identical to the numpy
        # regimes below (tests/test_render.py::test_native_resolve).
        # np.minimum.at's per-element dispatch is the difference between
        # ~100 s and ~1 s at a 16.7M-body 1080p frame.
        native.raster.stamp_discs(
            buf, h, w_,
            np.ascontiguousarray(cx, np.int64),
            np.ascontiguousarray(cy, np.int64),
            np.ascontiguousarray(r, np.float64),
            np.ascontiguousarray(keys, np.uint64),
        )
    else:
        _resolve_numpy(buf, cx, cy, keys, r, h, w_)

    hit = buf != np.uint64(0xFFFFFFFFFFFFFFFF)
    rgb_out = (buf[hit] & np.uint64(0xFFFFFF)).astype(np.uint32)
    flat_img = img.reshape(-1, 3)
    flat_img[hit, 0] = (rgb_out >> 16) & 0xFF
    flat_img[hit, 1] = (rgb_out >> 8) & 0xFF
    flat_img[hit, 2] = rgb_out & 0xFF
    return img


def _resolve_numpy(buf, cx, cy, keys, r, h, w_) -> None:
    """Pure-numpy depth resolve (fallback when no C compiler): same
    min-by-key result as the native stamp loop."""
    neg_r = -r  # ascending for searchsorted

    # Two regimes (both resolve through the same min-by-key depth test, so
    # the result is identical to a single global scatter-min):
    #  - large splats (r > _SMALL_MAX, rare): per-body 2D-slice minimum
    #    against the buffer under a cached circle mask — one vectorized op
    #    per body instead of (2r+1)^2 scattered passes.  This is what keeps
    #    a 500k-body close-up frame in seconds.
    #  - small splats (the bulk): the offset loop, <= (2*_SMALL_MAX+1)^2
    #    iterations, each touching only the bodies big enough to cover the
    #    offset (radius-sorted prefix).
    buf2d = buf.reshape(h, w_)
    n_large = int(np.searchsorted(neg_r, -float(_SMALL_MAX), side="left"))
    for i in range(n_large):
        _stamp_disc(buf2d, int(cx[i]), int(cy[i]), float(r[i]), keys[i], h, w_)

    cx, cy, keys = cx[n_large:], cy[n_large:], keys[n_large:]
    neg_r = neg_r[n_large:]
    if neg_r.size:
        rmax = int(math.ceil(-neg_r[0]))
        for dy in range(-rmax, rmax + 1):
            for dx in range(-rmax, rmax + 1):
                d = math.hypot(dx, dy)
                # circle SDF inclusion: |offset| <= r  (nbody3d.js:377-378)
                k = np.searchsorted(neg_r, -d, side="right")
                if k == 0:
                    continue
                x = cx[:k] + dx
                y = cy[:k] + dy
                ok = (x >= 0) & (x < w_) & (y >= 0) & (y < h)
                if not ok.any():
                    continue
                flat = y[ok] * w_ + x[ok]
                np.minimum.at(buf, flat, keys[:k][ok])
