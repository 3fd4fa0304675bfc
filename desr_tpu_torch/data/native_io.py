"""Native image decode (counterpart of ``desr_tpu/data/native_io.py``), and
the one place that routes the port's image reads.

PNG goes through ``csrc/dataio.cpp``, built with the host compiler into
``desr_tpu_torch/_build/`` on first use (``ops/_build.py``) and loaded with
``ctypes``; nothing is built at import. It decodes on zlib, not libpng, which
the card's machine does not have. JPEG goes through PIL, whose bundled
libjpeg-turbo is what imageio (and so the JAX package) reads JPEGs with, at
libjpeg's defaults (ISLOW IDCT, fancy upsampling): the same pixels.

``read_image(path)`` is the port's reader: a PNG or JPEG file (told by its
first bytes) to a uint8 array, or uint16 for a 16-bit PNG, (H, W) for grey
and (H, W, C) otherwise, palette PNGs expanded to RGB(A), as imageio reads
them. A malformed file raises ValueError. ``route()`` says which route it
takes, and why:

- ``("native", <library>; <JPEG decoder>)``: PNG through the library;
- ``("stdlib", <reason>; <JPEG decoder>)`` when the library cannot be built
  (no ``g++`` or no zlib header): PNGs through ``data/png.py`` (the same
  values; no palette, sub-byte or interlaced files).

On either route a JPEG needs PIL, and without it raises, naming what is
missing. The CLIs log the route once at start. This module imports no torch:
the serving CLI's and the metrics' spawned workers read through it.

The JAX module's interface is kept beside it: ``decode_png`` (every PNG as
uint16, 8-bit values unscaled), ``load_depth_normalized``,
``load_image_normalized``, ``resize_area`` and ``available``; they raise where
the JAX functions return None.
"""

from __future__ import annotations

import ctypes
import io
import threading

import numpy as np

from desr_tpu_torch.data.png import decode_png as _stdlib_png

_ERRORS = {-1: "not a PNG or JPEG file", -2: "corrupt or truncated",
           -3: "an encoding the decoder does not take (an interlaced PNG, or one of "
               "more than 4 GiB of pixels)",
           -4: "output buffer too small", -5: "out of host memory"}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8"

_lock = threading.Lock()
_state = None  # (library or None, detail): the route, decided once a process


def _load():
    global _state
    with _lock:
        if _state is None:
            from desr_tpu_torch.ops import _build

            try:
                lib = _build.load("dataio")
            except (RuntimeError, OSError) as e:  # no g++, no zlib.h, or no loadable library
                _state = (None, " ".join(str(e).split())[:400])
            else:
                c_int_p = ctypes.POINTER(ctypes.c_int)
                buf = (ctypes.c_char_p, ctypes.c_int64)
                lib.dio_png_info.argtypes = [*buf] + [c_int_p] * 4
                lib.dio_png.argtypes = [*buf, ctypes.c_void_p, ctypes.c_int64]
                lib.dio_png_info.restype = lib.dio_png.restype = ctypes.c_int
                f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
                u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
                lib.depth_to_norm.argtypes = [u16, f32, ctypes.c_int64, ctypes.c_float]
                lib.image_to_norm.argtypes = [u16, f32, ctypes.c_int64]
                lib.resize_area_f32.argtypes = [f32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                f32, ctypes.c_int, ctypes.c_int]
                for fn in (lib.depth_to_norm, lib.image_to_norm, lib.resize_area_f32):
                    fn.restype = None
                _state = (lib, _build.library_path("dataio"))
        return _state


def _jpeg_decoder():
    """PIL's Image module and what it decodes JPEG with, or None and why not."""
    try:
        from PIL import Image, features
    except ImportError as e:
        return None, f"JPEG: no decoder (PIL is not installed: {e})"
    turbo = features.version("libjpeg_turbo")
    jpeg = f"libjpeg-turbo {turbo}" if turbo else f"libjpeg {features.version('jpg')}"
    return Image, f"JPEG: PIL {Image.__version__} ({jpeg})"


def route():
    """``("native", library path; JPEG decoder)`` or ``("stdlib", why the
    library is missing; JPEG decoder)``; builds the library on the first call
    (the CLIs call it before they spawn workers)."""
    lib, detail = _load()
    detail = f"{detail}; {_jpeg_decoder()[1]}"
    return ("native", detail) if lib is not None else ("stdlib", detail)


def available() -> bool:
    return _load()[0] is not None


def _native():
    lib, detail = _load()
    if lib is None:
        raise RuntimeError(f"the native image library could not be built: {detail}")
    return lib


def _check(rc, path):
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'decode error {rc}')}")


def _decode_png_bytes(lib, data, path):
    w, h, c, bd = (ctypes.c_int() for _ in range(4))
    _check(lib.dio_png_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c), ctypes.byref(bd)), path)
    out = np.empty((h.value, w.value, c.value), np.uint16 if bd.value == 16 else np.uint8)
    _check(lib.dio_png(data, len(data), out.ctypes.data, out.nbytes), path)
    return out[..., 0] if c.value == 1 else out


def _decode_jpeg_bytes(data, path):
    Image, detail = _jpeg_decoder()
    if Image is None:
        raise RuntimeError(f"{path}: {detail}")
    try:
        with Image.open(io.BytesIO(data), formats=["JPEG"]) as im:
            if im.mode not in ("L", "RGB"):
                raise ValueError(f"{path}: a {im.mode} JPEG (colour decodes to RGB only)")
            return np.array(im)
    except (OSError, SyntaxError) as e:  # PIL's errors for a malformed file
        raise ValueError(f"{path}: {_ERRORS[-2]} ({e})") from e


def read_image(path) -> np.ndarray:
    """A PNG or JPEG file's pixels, on the route ``route()`` names."""
    with open(path, "rb") as f:
        data = f.read()
    lib = _load()[0]
    if data.startswith(_PNG_SIG):
        return _stdlib_png(data) if lib is None else _decode_png_bytes(lib, data, path)
    if data.startswith(_JPEG_SOI):
        return _decode_jpeg_bytes(data, path)
    raise ValueError(f"{path}: {_ERRORS[-1]}")


def decode_png(path) -> np.ndarray:
    """A PNG as uint16 (H, W) or (H, W, C), 8-bit values unscaled
    (native_io.py:84-101)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_png_bytes(_native(), data, path).astype(np.uint16)


def load_depth_normalized(path, max_mm=5100.0):
    """uint16 depth (mm) -> float32 [-1, 1] (H, W), clipped at ``max_mm``."""
    raw = decode_png(path)
    if raw.ndim == 3:
        raw = raw[..., 0]
    flat = np.ascontiguousarray(raw.reshape(-1))
    out = np.empty(flat.size, np.float32)
    _native().depth_to_norm(flat, out, flat.size, float(max_mm))
    return out.reshape(raw.shape)


def load_image_normalized(path):
    """RGB(A) PNG -> float32 [-1, 1] (H, W, 3)."""
    raw = decode_png(path)
    if raw.ndim != 3:
        raise ValueError(f"{path}: not a colour image")
    raw3 = np.ascontiguousarray(raw[..., :3])
    out = np.empty(raw3.size, np.float32)
    _native().image_to_norm(raw3.reshape(-1), out, raw3.size)
    return out.reshape(raw3.shape)


def resize_area(img_f32, out_h, out_w):
    """INTER_AREA box filter of a float32 (H, W) or (H, W, C) array, in float64 sums."""
    img = np.ascontiguousarray(img_f32, dtype=np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    _native().resize_area_f32(img.reshape(-1), h, w, c, out.reshape(-1), out_h, out_w)
    return out[..., 0] if squeeze else out
