"""Asynchronous frame writeback — the frame-loop IO executor.

The reference never persists frames: its output lives as a GPU texture
presented by the sprite pass (`src/ray_trace_output.rs:65-77`), so its
frame loop never blocks on IO.  A headless renderer writes every
frame to disk; doing that synchronously stalls the device for the
tone-map + encode + write time of each frame.  `FrameWriter` restores
the overlap: `submit()` copies the frame and returns immediately, a
native C++ worker pool (csrc/brt_native.cpp: brt_writer_*) tone-maps,
encodes and writes in the background, and `wait()` joins at the end of
the sequence.  Falls back to a Python thread pool over `write_image`
when the native library is unavailable (identical bytes either way —
same encoders).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from bevy_raytrace_tpu.io import native
from bevy_raytrace_tpu.io.image import write_image

_FMT = {".png": 0, ".ppm": 1, ".exr": 2}


class FrameWriter:
    """Background frame writer.

    Usage:
        with FrameWriter() as fw:
            for i in range(n):
                img = step(...)          # device renders frame i+1 while
                fw.submit(path_i, img)   # ...frame i encodes on the host
        # __exit__ waits and raises if any frame failed to write
    """

    def __init__(self, n_threads: int = 2):
        self._lib = native.load()
        self._handle = None
        self._pool = None
        self._n_threads = int(n_threads)
        self._futures = []
        if self._lib is not None:
            self._handle = self._lib.brt_writer_create(int(n_threads))
        if self._handle is None:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n_threads)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def submit(self, path: str, img) -> None:
        """Enqueue a linear float — or pre-tone-mapped uint8 — [H, W, 3]
        frame; returns immediately.

        The buffer is copied before returning, so callers may overwrite
        or free `img` right away.  Format follows the extension
        (.png / .ppm / .exr, same dispatch as `write_image`).

        uint8 frames are already gamma-2 tone-mapped (the device-side
        tone-map path ships 3 bytes/pixel from the device, not 12 — see
        cli animate); they are encoded as-is.  EXR needs linear float.
        """
        ext = os.path.splitext(path)[1].lower()
        if ext not in _FMT:
            raise ValueError(f"unsupported image extension: {path}")
        # Validate before the native/fallback branch: the thread-pool
        # fallback would otherwise accept a malformed frame here and only
        # surface the error later from the worker at wait().
        rgb = np.asarray(img)
        if rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] frame, got {rgb.shape}")
        if rgb.dtype == np.uint8:
            if ext == ".exr":
                raise ValueError("EXR output needs a linear float frame")
            if self._pool is None:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._n_threads)
            arr = np.ascontiguousarray(rgb)
            self._futures.append(self._pool.submit(write_image, path, arr))
            return
        rgb = np.ascontiguousarray(rgb, np.float32)
        if self._handle is not None:
            h, w, _ = rgb.shape
            rc = self._lib.brt_writer_submit(
                self._handle,
                path.encode(),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                w,
                h,
                _FMT[ext],
            )
            if rc != 0:
                raise RuntimeError(f"brt_writer_submit failed ({rc})")
        else:
            arr = np.array(rgb, np.float32, copy=True)
            self._futures.append(self._pool.submit(write_image, path, arr))

    def wait(self) -> None:
        """Block until every submitted frame is on disk; raise on failure.

        Both queues are drained: a native writer can hold float frames
        while uint8 frames ride the thread pool."""
        native_failed = 0
        if self._handle is not None:
            native_failed = self._lib.brt_writer_wait(self._handle)
        futures, self._futures = self._futures, []
        errors = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — collected below
                errors.append(e)
        if native_failed or errors:
            # Match the native path: report ALL failures, not just
            # the first future's.
            raise IOError(
                f"{native_failed + len(errors)} frame(s) failed to write"
                + (": " + "; ".join(str(e) for e in errors[:4])
                   if errors else ""))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.brt_writer_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.wait()
        finally:
            self.close()
        return False
