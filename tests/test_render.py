"""Renderer tests: projection, sizing, colormap, depth, golden hash
(SURVEY §4.6)."""

import hashlib

import numpy as np
import pytest

from nbody3d_tpu.render.colormap import velocity_colormap
from nbody3d_tpu.render.rasterize import project_points, render_points
from nbody3d_tpu.utils.camera import Camera


def centered_camera(radius=5.0):
    return Camera(target=np.zeros(3), radius=radius)


def test_colormap_reference_formula():
    """(v, 1-|v-0.5|, 1-v) at |vel|/40 (nbody3d.js:371-380)."""
    np.testing.assert_allclose(velocity_colormap(0.0), [0.0, 0.5, 1.0])
    np.testing.assert_allclose(velocity_colormap(20.0), [0.5, 1.0, 0.5])
    np.testing.assert_allclose(velocity_colormap(40.0), [1.0, 0.5, 0.0])
    np.testing.assert_allclose(velocity_colormap(80.0), [1.0, 0.0, 0.0])  # clamped


def test_project_center_body():
    cam = centered_camera()
    px, py, depth, w = project_points(np.zeros((1, 3)), cam, 640, 480)
    assert np.isclose(px[0], 320.0)
    assert np.isclose(py[0], 240.0)
    assert 0.0 < depth[0] < 1.0
    assert np.isclose(w[0], 5.0)  # view-space distance


def test_single_body_renders_centered_disc():
    cam = centered_camera()
    pos_mass = np.array([[0, 0, 0, 1e6]], np.float32)
    vel = np.zeros((1, 4), np.float32)
    img = render_points(pos_mass, vel, cam, width=256, height=256, size_factor=1000.0)
    # center pixel colored with colormap(0) = (0, .5, 1) -> (0, 127, 255)
    center = img[128, 128]
    assert center[2] == 255 and center[1] in (127, 128) and center[0] == 0
    # corners are background
    assert tuple(img[0, 0]) == (0, 0, 0)
    # mass 1e6 -> world radius ~62/1000 -> ~2.75 px at this resolution:
    # a proper disc, not a single pixel
    lit = (img.sum(axis=2) > 0).sum()
    assert lit > 4


def test_depth_test_closer_wins():
    cam = centered_camera()
    # Two coincident-in-screen bodies at different depths with different
    # speeds (=> colors); the closer (z = +1 toward camera at (0,0,5)).
    pos_mass = np.array([[0, 0, 1.0, 1e6], [0, 0, -1.0, 1e6]], np.float32)
    vel = np.array([[40.0, 0, 0, 0], [0.0, 0, 0, 0]], np.float32)  # near: red-ish
    img = render_points(pos_mass, vel, cam, width=64, height=64, size_factor=1000.0)
    center = img[32, 32]
    # near body color = colormap(1) = (1, .5, 0)
    assert center[0] == 255 and center[2] == 0


def test_behind_camera_culled():
    cam = centered_camera()
    pos_mass = np.array([[0, 0, 100.0, 1e6]], np.float32)  # behind eye at z=5
    vel = np.zeros((1, 4), np.float32)
    img = render_points(pos_mass, vel, cam, width=32, height=32, size_factor=1000.0)
    assert img.sum() == 0


def test_min_size_clamp_keeps_far_bodies_visible():
    """2*dist/f minimum (nbody3d.js:358): a tiny-mass far body still lights
    at least one pixel."""
    cam = centered_camera(radius=50.0)
    pos_mass = np.array([[0, 0, 0, 1.0]], np.float32)
    vel = np.zeros((1, 4), np.float32)
    img = render_points(pos_mass, vel, cam, width=64, height=64, size_factor=1000.0)
    assert (img.sum(axis=2) > 0).sum() >= 1


def test_golden_hash_stable():
    """Determinism lock: fixed small scene hashes identically across runs."""
    rng = np.random.default_rng(42)
    n = 200
    pos_mass = np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    vel = np.concatenate(
        [rng.normal(scale=15.0, size=(n, 3)), np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    cam = centered_camera()
    img1 = render_points(pos_mass, vel, cam, width=128, height=96, size_factor=1000.0)
    img2 = render_points(pos_mass, vel, cam, width=128, height=96, size_factor=1000.0)
    assert hashlib.sha256(img1.tobytes()).hexdigest() == hashlib.sha256(img2.tobytes()).hexdigest()
    assert (img1.sum(axis=2) > 0).sum() > 50  # plenty of bodies visible


def test_save_png(tmp_path):
    from nbody3d_tpu.render.image import save_png

    img = np.zeros((8, 8, 3), np.uint8)
    img[2, 3] = [255, 10, 20]
    path = tmp_path / "f.png"
    save_png(str(path), img)
    from PIL import Image

    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, img)


def test_direction_colormap():
    """normalize(vel)*0.5+0.5 (nbody3d.js:381)."""
    from nbody3d_tpu.render.colormap import direction_colormap

    rgb = direction_colormap(np.array([[10.0, 0, 0], [0, -5.0, 0], [0, 0, 0]]))
    np.testing.assert_allclose(rgb[0], [1.0, 0.5, 0.5])
    np.testing.assert_allclose(rgb[1], [0.5, 0.0, 0.5])
    np.testing.assert_allclose(rgb[2], [0.5, 0.5, 0.5])  # zero vel -> gray


def test_render_color_mode_direction():
    cam = centered_camera()
    pos_mass = np.array([[0, 0, 0, 1e6]], np.float32)
    vel = np.array([[50.0, 0, 0, 0]], np.float32)  # +x => red-dominant
    img = render_points(pos_mass, vel, cam, width=128, height=128,
                        size_factor=1000.0, color_mode="direction")
    center = img[64, 64]
    assert center[0] == 255 and center[1] in (127, 128) and center[2] in (127, 128)


def test_large_splat_path_matches_offset_loop():
    """The per-body disc fast path (r > _SMALL_MAX) must produce exactly
    what the shared offset loop would: force all bodies down one path or
    the other by scaling radii, same scene."""
    from nbody3d_tpu.render import rasterize

    rng = np.random.default_rng(5)
    n = 64
    pos_mass = np.concatenate(
        [rng.normal(scale=1.0, size=(n, 3)), rng.uniform(1e4, 8e4, (n, 1))],
        axis=1,
    ).astype(np.float32)
    vel = rng.normal(size=(n, 4)).astype(np.float32)
    cam = Camera(target=np.zeros(3))
    kw = dict(width=160, height=120, size_factor=100.0, resolve="numpy")
    img_mixed = rasterize.render_points(pos_mass, vel, cam, **kw)
    # force everything through the offset loop by raising the threshold
    old = rasterize._SMALL_MAX
    try:
        rasterize._SMALL_MAX = 10**9
        img_loop = rasterize.render_points(pos_mass, vel, cam, **kw)
        rasterize._SMALL_MAX = 0  # everything through the per-body path
        img_disc = rasterize.render_points(pos_mass, vel, cam, **kw)
    finally:
        rasterize._SMALL_MAX = old
    np.testing.assert_array_equal(img_mixed, img_loop)
    np.testing.assert_array_equal(img_mixed, img_disc)


def test_native_resolve_matches_numpy():
    """The C depth-resolve (native/_raster.c) is bit-identical to the
    numpy two-regime resolve on a dense multi-scale scene (overlapping
    splats, heavy centrals, partially off-screen discs)."""
    from nbody3d_tpu import native

    if native.raster is None:
        import pytest

        pytest.skip("no C compiler for the native raster module")
    rng = np.random.default_rng(11)
    n = 4000
    pos_mass = np.concatenate(
        [rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))],
        axis=1,
    ).astype(np.float32)
    pos_mass[:3, 3] = 1e7  # big splats incl. clipped ones
    pos_mass[1, :3] = [4.0, 4.0, 0.0]
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    cam = Camera(target=np.zeros(3), radius=3.0)
    kw = dict(width=320, height=240, prep="host")
    a = render_points(pos_mass, vel, cam, resolve="numpy", **kw)
    b = render_points(pos_mass, vel, cam, resolve="native", **kw)
    np.testing.assert_array_equal(a, b)


def test_device_prep_matches_host():
    """The device (f32 jnp) projection/color/sort prep — the 16M-scale
    path — produces the same frame as the host f64 prep
    on a dense multi-scale scene (minor sub-pixel rounding differences
    allowed, but none observed on this seed)."""
    rng = np.random.default_rng(9)
    n = 5000
    pos_mass = np.concatenate(
        [rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))],
        axis=1,
    ).astype(np.float32)
    pos_mass[0, 3] = 1e7
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    cam = Camera(target=np.zeros(3), radius=5.0)
    kw = dict(width=320, height=240)
    a = render_points(pos_mass, vel, cam, prep="host", **kw)
    b = render_points(pos_mass, vel, cam, prep="device", **kw)
    agree = (a == b).all(axis=2).mean()
    assert agree > 0.999, agree


def test_device_resolve_matches_host():
    """The on-accelerator scatter-min resolve (the relay-friendly 16M
    path) reproduces the exact host resolve up to its stated contract:
    16-bit depth test, rgb565 color (<= 4/255 per channel after bit
    replication).  Pixel winners only differ where two splats land
    within 2^-16 of the depth range."""
    rng = np.random.default_rng(13)
    n = 20_000
    pos_mass = np.concatenate(
        [rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))],
        axis=1,
    ).astype(np.float32)
    pos_mass[:2, 3] = 1e7  # large splats exercise the host-prefix path
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    cam = Camera(target=np.zeros(3), radius=4.0)
    kw = dict(width=320, height=240)
    a = render_points(pos_mass, vel, cam, prep="device", **kw)
    b = render_points(pos_mass, vel, cam, resolve="device", **kw)
    # background and lit sets agree except for rare depth-tie flips
    lit_a = a.any(axis=2)
    lit_b = b.any(axis=2)
    assert (lit_a == lit_b).mean() > 0.999
    both = lit_a & lit_b
    diff = np.abs(a[both].astype(int) - b[both].astype(int))
    close = (diff <= 8).all(axis=1)  # rgb565 quantization band
    assert close.mean() > 0.995, close.mean()
    # determinism: same call twice is bit-identical
    c = render_points(pos_mass, vel, cam, resolve="device", **kw)
    np.testing.assert_array_equal(b, c)


def test_device_resolve_single_body():
    """A single small body lands on the same pixel with the same
    (quantized) color through the device resolve."""
    cam = centered_camera()
    pos_mass = np.array([[0, 0, 0, 100.0]], np.float32)
    vel = np.zeros((1, 4), np.float32)
    kw = dict(width=128, height=128, size_factor=1000.0)
    a = render_points(pos_mass, vel, cam, **kw)
    b = render_points(pos_mass, vel, cam, resolve="device", **kw)
    assert a[64, 64].any() and b[64, 64].any()
    assert np.abs(a[64, 64].astype(int) - b[64, 64].astype(int)).max() <= 8


def _scene(n, seed, radius=4.0, heavy=2):
    rng = np.random.default_rng(seed)
    pos_mass = np.concatenate(
        [rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))],
        axis=1,
    ).astype(np.float32)
    pos_mass[:heavy, 3] = 1e7  # r >= 2: exercises the host-prefix stamp
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    return pos_mass, vel, Camera(target=np.zeros(3), radius=radius)


@pytest.mark.parametrize(
    "n,seed,radius,heavy,size",
    [
        (3000, 1, 4.0, 2, (320, 240)),
        (8000, 2, 2.0, 5, (256, 160)),  # close-up: many clipped large discs
        (500, 3, 9.0, 0, (64, 48)),  # far: all small splats, no prefix
    ],
)
def test_device_resolve_equals_quantized_host_stamp(n, seed, radius, heavy, size):
    """The device resolve's contract, exactly: the host stamp semantics
    with every key quantized to depth16 << 16 | rgb565.  Stamping the
    same device-prepped splats on the host under that key gives the same
    frame bit for bit."""
    from nbody3d_tpu.render import rasterize as rz

    pos_mass, vel, cam = _scene(n, seed, radius, heavy)
    w, h = size
    dev = render_points(pos_mass, vel, cam, width=w, height=h, resolve="device")
    cx, cy, keys, r = rz._prep_device(
        pos_mass, vel, cam, w, h, 1000.0, 64, "magnitude"
    )
    depth_bits = (keys >> np.uint64(32)).astype(np.uint32)
    rgb24 = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    host = rz.composite_device_frame(
        np.full(w * h, 0xFFFFFFFF, np.uint32),
        (cx, cy, depth_bits, rgb24, r), w, h,
    )
    np.testing.assert_array_equal(dev, host)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's own output (8-bit RGB, filter 0)."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (48, 64)])
def test_png_writer_roundtrip(tmp_path, shape):
    """The standard-library PNG writer round-trips exactly (no Pillow)."""
    from nbody3d_tpu.render.image import save_png

    img = np.random.default_rng(0).integers(
        0, 256, shape + (3,), dtype=np.uint8
    )
    path = tmp_path / "f.png"
    save_png(str(path), img)
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), img)


def test_png_writer_rejects_non_rgb():
    from nbody3d_tpu.render.image import encode_png

    with pytest.raises(ValueError, match="H, W, 3"):
        encode_png(np.zeros((4, 4), np.uint8))
