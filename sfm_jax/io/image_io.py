"""Image loading (PPM/PGM native, PIL fallback) and point-cloud export.

Replaces the reference's OpenCV image ingest (reference
src/main.cpp:251-257 loads PPMs as CV_32FC1 grayscale, values 0..255)
and its OpenGL viewer output (src/main.cpp:318-352) with headless PLY
export.  A native C++ loader (see native/) accelerates batch ingest;
this module is the always-available pure-Python path.
"""

from __future__ import annotations

import pathlib

import numpy as np

def _read_pnm_header(data: bytes):
    """Tokenize the PNM header (comment- and whitespace-robust);
    returns (w, h, maxval, pixel_data_offset)."""
    pos = 2
    vals = []
    n = len(data)
    while len(vals) < 3:
        # skip whitespace and comments
        while pos < n:
            c = data[pos]
            if c == 0x23:  # '#'
                while pos < n and data[pos] != 0x0A:
                    pos += 1
            elif c in (0x20, 0x09, 0x0D, 0x0A):
                pos += 1
            else:
                break
        start = pos
        while pos < n and 0x30 <= data[pos] <= 0x39:
            pos += 1
        if pos == start:
            raise ValueError("bad PNM header")
        vals.append(int(data[start:pos]))
    return vals[0], vals[1], vals[2], pos + 1  # single ws after maxval


def load_gray(path) -> np.ndarray:
    """Load an image as [H, W] float32 grayscale, 0..255 scale.

    Grayscale conversion for color inputs matches OpenCV's BGR->GRAY
    weights (0.299 R + 0.587 G + 0.114 B) used implicitly by the
    reference's IMREAD_GRAYSCALE (src/main.cpp:251-252).
    """
    path = pathlib.Path(path)
    data = path.read_bytes()
    magic = data[:2]
    if magic in (b"P5", b"P6"):
        w, h, maxval, off = _read_pnm_header(data)
        dtype = np.uint8 if maxval < 256 else ">u2"
        ch = 3 if magic == b"P6" else 1
        img = np.frombuffer(data, dtype=dtype, count=w * h * ch, offset=off)
        img = img.reshape(h, w, ch).astype(np.float32)
        if maxval != 255:
            img = img * (255.0 / maxval)
        if ch == 3:
            img = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
        else:
            img = img[..., 0]
        return img
    # Fallback: PIL for PNG/JPG/etc.
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("F"), dtype=np.float32)


def iter_gray_frames(paths, depth: int = 4, n_threads: int = 0):
    """Yield (index, [H, W] f32) frames in order with decode-ahead.

    Native path: C++ worker pool decoding `depth` frames ahead of the
    consumer (native/sfm_io.cpp sfm_prefetch_*), so sequence-mode frame
    ingest overlaps accelerator compute (the reference decodes
    synchronously per frame, src/main.cpp:251-257).  Pure-Python
    fallback: a ThreadPoolExecutor with a bounded window of in-flight
    decodes.
    """
    paths = [str(p) for p in paths]

    def _all_pnm():
        # The native decoder handles PNM only; anything else (PNG/JPG,
        # which load_gray routes to PIL) must take the Python path so
        # behavior doesn't depend on whether the toolchain is present.
        try:
            for p in paths:
                with open(p, "rb") as f:
                    if f.read(2) not in (b"P5", b"P6"):
                        return False
        except OSError:
            return False
        return True

    pf = None
    try:
        from sfm_jax.io import native as _native

        if _all_pnm() and _native.available():
            pf = _native.FramePrefetcher(paths, depth=depth, n_threads=n_threads)
    except (RuntimeError, ValueError):
        pf = None  # open-time failure only: fall back before any yield
    if pf is not None:
        with pf:
            yield from pf
        return
    import concurrent.futures as _cf

    if depth <= 0:
        depth = 4
    with _cf.ThreadPoolExecutor(max_workers=max(1, min(depth, 8))) as ex:
        pending = {}
        nxt = 0
        for i, p in enumerate(paths):
            pending[i] = ex.submit(load_gray, p)
            while len(pending) >= depth or (
                i == len(paths) - 1 and pending
            ):
                yield nxt, pending.pop(nxt).result()
                nxt += 1


def save_ply(path, points, colors=None, valid=None):
    """Write a PLY point cloud (replaces the GL viewer output).

    Uses the native binary writer (native/sfm_io.cpp) when available,
    else a pure-Python ASCII fallback.  Returns the vertex count."""
    try:
        from sfm_jax.io import native as _native

        if _native.available():
            return _native.save_ply(path, points, colors=colors, valid=valid)
    except Exception:
        pass
    points = np.asarray(points)
    if valid is not None:
        mask = np.asarray(valid).astype(bool)
        points = points[mask]
        if colors is not None:
            colors = np.asarray(colors)[mask]
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
    return n
