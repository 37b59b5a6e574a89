"""Frame output: PNG (standard library only), raw NPY dumps, and
animations (Pillow, imported only when asked for)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, no interlace, filter 0 on
    every row, one zlib stream."""
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    )
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _png_chunk(b"IEND", b""),
    ])


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "animations need Pillow (pip install pillow); PNG frames do not"
        ) from e
    return Image


def save_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))


def save_animation(frames, path: str, *, fps: float = 30.0) -> None:
    """Assemble frames into a watchable video file.

    ``frames``: iterable of (H, W, 3) uint8 arrays OR of PNG file paths.
    Format by suffix: ``.gif`` / ``.png``/``.apng`` are written with
    Pillow; ``.mp4``/``.webm`` shell out to ffmpeg when it is
    on PATH, else raise with a hint to use .gif.  This is the headless
    counterpart of actually *watching* the reference's canvas
    (``nbody3d.js:439-514``).
    """
    import os

    Image = _pillow()

    def to_image(f):
        if isinstance(f, (str, os.PathLike)):
            return Image.open(f).convert("RGB")
        return Image.fromarray(np.asarray(f, dtype=np.uint8), mode="RGB")

    frames = list(frames)
    if not frames:
        raise ValueError("no frames to assemble")
    suffix = os.path.splitext(str(path))[1].lower()
    duration_ms = max(1, round(1000.0 / fps))

    if suffix in (".gif", ".png", ".apng"):
        imgs = [to_image(f) for f in frames]
        imgs[0].save(
            path,
            save_all=True,
            append_images=imgs[1:],
            duration=duration_ms,
            loop=0,
        )
        return
    if suffix in (".mp4", ".webm"):
        import shutil
        import subprocess
        import tempfile

        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise RuntimeError(
                f"ffmpeg not found on PATH (needed for {suffix}); "
                "use a .gif output instead"
            )
        with tempfile.TemporaryDirectory() as td:
            for i, f in enumerate(frames):
                to_image(f).save(os.path.join(td, f"f_{i:06d}.png"))
            subprocess.run(
                [
                    ffmpeg, "-y", "-framerate", str(fps),
                    "-i", os.path.join(td, "f_%06d.png"),
                    "-pix_fmt", "yuv420p", str(path),
                ],
                check=True,
                capture_output=True,
            )
        return
    raise ValueError(f"unsupported animation format {suffix!r} (gif/png/mp4/webm)")
