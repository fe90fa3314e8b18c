"""Image writeback: tone-map + PNG/PPM/EXR.

The reference never persists an image — output exists only as a live
window texture (`src/ray_trace_output.rs:65-77`; SURVEY.md §5 "images are
never even written to disk").  Headless rendering makes writeback a
first-class feature: PNG/PPM for display (gamma-2 per RTiOW write_color),
EXR for linear HDR.

Encoding runs in the native C++ runtime when available (csrc/, loaded via
ctypes) with a pure-Python fallback (stdlib zlib for PNG).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from bevy_raytrace_tpu.io import native


def tonemap(img) -> np.ndarray:
    """Linear float [H,W,3] -> gamma-2 uint8 (RTiOW's sqrt write_color)."""
    img = np.asarray(img, np.float32)
    lib = native.load()
    if lib is not None:
        flat = np.ascontiguousarray(img).reshape(-1)
        out = np.empty(flat.size, np.uint8)
        lib.brt_tonemap_srgb(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            flat.size,
        )
        return out.reshape(img.shape)
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write a linear float image (or uint8) as gamma-2 PNG."""
    rgb = img if np.asarray(img).dtype == np.uint8 else tonemap(img)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    lib = native.load()
    if lib is not None:
        rc = lib.brt_write_png(
            path.encode(),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w,
            h,
        )
        if rc == 0:
            return
    _write_png_py(path, rgb)


def png_bytes(img) -> bytes:
    """Encode a linear float (or uint8) image as PNG bytes in memory
    (stdlib zlib; the `cli serve` live-viewer path, where frames go to
    an HTTP response instead of disk)."""
    rgb = img if np.asarray(img).dtype == np.uint8 else tonemap(img)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _write_png_py(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def write_ppm(path: str, img) -> None:
    rgb = img if np.asarray(img).dtype == np.uint8 else tonemap(img)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    lib = native.load()
    if lib is not None:
        if lib.brt_write_ppm(
            path.encode(),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w,
            h,
        ) == 0:
            return
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def write_exr(path: str, img) -> None:
    """Write linear float32 HDR as minimal uncompressed EXR (native only)."""
    img = np.ascontiguousarray(np.asarray(img, np.float32))
    h, w, _ = img.shape
    lib = native.load()
    if lib is None:
        raise RuntimeError(
            "EXR writeback requires the native library (make -C csrc)"
        )
    rc = lib.brt_write_exr(
        path.encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w,
        h,
    )
    if rc != 0:
        raise IOError(f"brt_write_exr failed with {rc}")


def write_image(path: str, img) -> None:
    """Dispatch on extension: .png / .ppm / .exr."""
    low = path.lower()
    if low.endswith(".png"):
        write_png(path, img)
    elif low.endswith(".ppm"):
        write_ppm(path, img)
    elif low.endswith(".exr"):
        write_exr(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


def assemble_tiles(tiles, starts, num_pixels: int) -> np.ndarray:
    """Gather per-device/host framebuffer stripes into one flat image.

    The multi-host IO path: each host materializes only its own pixel
    stripes (addressable shards) and rank 0 assembles them for writing —
    the headless analog of the reference's single resident framebuffer texture
    (`src/ray_trace_output.rs:49-61`).  `tiles` is a list of [n_i, 3]
    float32 arrays, `starts` their absolute pixel offsets.  Uses the
    native `brt_assemble_tiles` (csrc/brt_native.cpp) when available,
    else numpy.
    """
    tiles = [np.ascontiguousarray(t, np.float32).reshape(-1, 3)
             for t in tiles]
    # Validate every stripe BEFORE dispatch: the native path is a raw
    # memcpy loop, so an inconsistent stripe would be an out-of-bounds
    # heap write there (and a shape-mismatch ValueError in numpy) —
    # identical error either way.
    if len(tiles) != len(starts):
        raise ValueError(
            f"{len(tiles)} tiles but {len(starts)} starts")
    for t, s0 in zip(tiles, starts):
        s0 = int(s0)
        if s0 < 0 or s0 + t.shape[0] > num_pixels:
            raise ValueError(
                f"tile stripe [{s0}, {s0 + t.shape[0]}) out of bounds for "
                f"num_pixels={num_pixels}")
    out = np.zeros((num_pixels, 3), np.float32)
    lib = native.load()
    if lib is not None:
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(tiles))(
            *[t.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for t in tiles])
        starts_a = np.asarray(starts, np.int64)
        sizes_a = np.asarray([t.shape[0] for t in tiles], np.int64)
        lib.brt_assemble_tiles(
            ptrs,
            starts_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(tiles),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    for t, s0 in zip(tiles, starts):
        out[int(s0):int(s0) + t.shape[0]] = t
    return out
