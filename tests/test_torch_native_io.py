"""The port's image decode (``data/native_io.py``: PNG through
``desr_tpu_torch/csrc/dataio.cpp``, JPEG through PIL) on the CPU: PNG against
the JAX package's libpng decode (``desr_tpu/data/native_io.py``), JPEG
against ``imageio.v2.imread``, the frame loaders against the JAX ones, a
``TranslationDataset`` with ``.jpg`` colour frames against the JAX dataset,
malformed files (an error, never a crash), and the stdlib route (no native
library), selected here by the tests that name it."""

import hashlib
import importlib.util
import os
import struct
import subprocess
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import test_torch_translation_data as TD
from desr_tpu_torch.data import native_io, png
from desr_tpu_torch.data.base_dataset import load_depth_png, load_image

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jpeg_968x1296.jpg")
# sha256 of imageio.v2.imread(FIXTURE)'s pixels (uint8, 968x1296x3, C order);
# chip_smoke.py holds the card machine's decode to the same value
FIXTURE_SHA256 = "eaf0616b7e2e389d4cb152e06c67e2207c92bbd2cbea8d838144e82c7ff3ae08"

PNG_KINDS = ["grey8", "rgb8", "rgba8", "palette", "grey16", "rgb16", "rgb16_low"]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """A private instance of the JAX package's native module, bound to its
    library built here from ``native/dataio.cpp`` with ``native/Makefile``'s
    command. The module's own build writes straight into ``native/``, where
    another test worker may be loading or building it at the same time."""
    from desr_tpu.data import native_io as J

    lib = tmp_path_factory.mktemp("jax_dataio") / "libdesr_dataio.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(lib),
                    os.path.join(ROOT, "native", "dataio.cpp"), "-lpng", "-lz"],
                   check=True, capture_output=True, timeout=120)
    spec = importlib.util.spec_from_file_location("jax_native_io_private", J.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._LIB_PATH = str(lib)
    assert mod.available(), "the JAX package's native PNG library did not load"
    return mod


def _write_png(path, kind, hw=(24, 40), seed=0):
    """A PNG of ``kind`` written by cv2 (the palette one by PIL: cv2 writes none)."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    if kind == "palette":
        Image.fromarray(rgb).quantize(32).save(path)
        return
    arr = {"grey8": rgb[..., 0], "rgb8": rgb,
           "rgba8": np.concatenate([rgb, rgb[..., :1]], axis=-1),
           "grey16": rng.integers(0, 65536, hw, dtype=np.uint16),
           "rgb16": rng.integers(0, 65536, hw + (3,), dtype=np.uint16),
           "rgb16_low": rgb.astype(np.uint16)}[kind]  # 16-bit colour within 0..255
    if arr.ndim == 3:  # cv2 writes BGR(A)
        arr = arr[..., [2, 1, 0, 3][:arr.shape[2]]]
    assert cv2.imwrite(str(path), arr)


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_decode_png_equals_jax_native(tmp_path, kind, jax_native):
    """``decode_png`` (every PNG as uint16, palette expanded to RGB) is equal
    to the JAX package's libpng decode; ``read_image`` gives the same values at
    the file's bit depth, as imageio does, but for 16-bit colour: imageio
    (PIL's 8-bit RGB mode) keeps each sample's high byte there, where
    ``read_image`` keeps the uint16 values, as both packages' PNG decoders do."""
    J = jax_native
    path = tmp_path / f"{kind}.png"
    _write_png(path, kind)
    got, want = native_io.decode_png(path), J.decode_png(path)
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    img = native_io.read_image(path)
    assert img.dtype == (np.uint16 if "16" in kind else np.uint8)
    np.testing.assert_array_equal(img, want)
    if kind.startswith("rgb16"):
        np.testing.assert_array_equal(img >> 8, imageio.imread(path))
    else:
        np.testing.assert_array_equal(img, imageio.imread(path))


def test_helpers_equal_jax(tmp_path, jax_native):
    """``load_depth_normalized``, ``load_image_normalized`` (the C++
    normalisers) and ``resize_area`` (the INTER_AREA box filter) are
    bit-equal to the JAX package's: the same C++ arithmetic."""
    J = jax_native
    rng = np.random.default_rng(1)
    depth = tmp_path / "d.png"
    assert cv2.imwrite(str(depth), rng.integers(0, 8000, (30, 44), dtype=np.uint16))
    img = tmp_path / "i.png"
    _write_png(img, "rgba8", (30, 44), 2)
    for max_mm in (5100.0, 10.0):
        np.testing.assert_array_equal(native_io.load_depth_normalized(depth, max_mm),
                                      J.load_depth_normalized(depth, max_mm))
    np.testing.assert_array_equal(native_io.load_image_normalized(img),
                                  J.load_image_normalized(img))
    x = rng.uniform(-1, 1, (30, 44, 3)).astype(np.float32)
    for hw in ((15, 22), (13, 29), (60, 88)):
        np.testing.assert_array_equal(native_io.resize_area(x, *hw), J.resize_area(x, *hw))
        np.testing.assert_array_equal(native_io.resize_area(x[..., 0], *hw),
                                      J.resize_area(x[..., 0], *hw))


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_frame_loaders_equal_jax(tmp_path, kind, jax_native, monkeypatch):
    """``load_image`` and ``load_depth_png`` return the JAX functions' values
    and dtypes: 8-bit grey comes back uint16 and 16-bit colour within 0..255
    uint8, as the JAX functions' uint16 decode and cast give them."""
    import desr_tpu.data
    from desr_tpu.data import base_dataset as JB

    monkeypatch.setattr(desr_tpu.data, "native_io", jax_native)  # what JB imports

    path = tmp_path / f"{kind}.png"
    _write_png(path, kind)
    for port, jax_fn in ((load_image, JB.load_image), (load_depth_png, JB.load_depth_png)):
        got, want = port(path), jax_fn(path)
        assert got.dtype == want.dtype and got.shape == want.shape, (port.__name__, got.dtype)
        np.testing.assert_array_equal(got, want)


def _scene(hw, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    img = np.stack([120 + 90 * np.sin(x / 13 + y / 17), 120 + 80 * np.cos(x / 11 - y / 7),
                    110 + 70 * np.sin((x + y) / 19)], -1) + rng.normal(0, 6, hw + (3,))
    return np.clip(img, 0, 255).astype(np.uint8)


JPEG_CASES = {
    "420": [cv2.IMWRITE_JPEG_QUALITY, 90],
    "444": [cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422_restarts": [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "440": [cv2.IMWRITE_JPEG_QUALITY, 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "progressive": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "grey": [cv2.IMWRITE_JPEG_QUALITY, 90],
    "grey_progressive": [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
@pytest.mark.parametrize("hw", [(61, 83), (17, 9)])
def test_jpeg_is_bit_equal_to_imageio(tmp_path, case, hw):
    """Colour (4:2:0, 4:4:4, 4:2:2 with restart markers, 4:4:0, progressive)
    to uint8 (H, W, 3), grey to uint8 (H, W): bit-equal to imageio.v2.imread,
    odd sizes included (partial MCUs, the upsampling's edge columns)."""
    img = _scene(hw, 3)
    path = str(tmp_path / f"{case}.jpg")
    assert cv2.imwrite(path, img[..., 1] if case.startswith("grey") else img[..., ::-1],
                       JPEG_CASES[case])
    got, want = native_io.read_image(path), imageio.imread(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_jpeg_fixture_matches_recorded_sha256():
    """The committed 968x1296 fixture (ScanNet's colour geometry, cv2 quality
    90): imageio's pixels hash to the recorded value, and ``read_image``'s
    equal them."""
    want = imageio.imread(FIXTURE)
    assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() == FIXTURE_SHA256
    np.testing.assert_array_equal(native_io.read_image(FIXTURE), want)


def test_cmyk_and_non_images_raise(tmp_path):
    cmyk = tmp_path / "c.jpg"
    Image.fromarray(_scene((16, 16), 4)).convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match="CMYK"):
        native_io.read_image(cmyk)
    other = tmp_path / "x.bmp"
    Image.fromarray(_scene((16, 16), 4)).save(other)
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        native_io.read_image(other)


def test_translation_dataset_with_jpg_frames_matches_jax(tmp_path):
    """Stage 2's dataset on .jpg colour frames (ScanNet's export) and 16-bit
    PNG depth: items equal to the JAX dataset's (imageio reads both), within
    the 1e-5 of test_torch_translation_data.py::test_translation_dataset_matches_jax."""
    from desr_tpu.data.translation_dataset import TranslationDataset as JaxDataset
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    TD._write_dataroot(tmp_path, 3, 2)
    for d in ("trainA", "trainB"):
        folder = tmp_path / d / "img"
        for f in sorted(os.listdir(folder)):
            img = png.read_png(folder / f)[..., :3]
            os.remove(folder / f)
            assert cv2.imwrite(str(folder / f.replace(".png", ".jpg")), img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
    opt = TD._opt(tmp_path)
    got, want = TranslationDataset(opt, "train"), JaxDataset(opt, "train")
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert (a["A_name"], a["B_name"]) == (b["A_name"], b["B_name"])
        for k in ("A_depth", "A_img", "B_depth", "B_img"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)


def test_stdlib_route_reads_png_and_refuses_jpeg(tmp_path, monkeypatch):
    """Without the native library (selected here) the route says so and why;
    PNGs read through data/png.py give the native route's values; a JPEG
    still reads through PIL, and without PIL (selected too) raises, naming
    the file and what is missing."""
    paths = []
    for kind in ("grey8", "rgb8", "rgba8", "grey16", "rgb16"):
        paths.append(tmp_path / f"{kind}.png")
        _write_png(paths[-1], kind)
    native = [native_io.read_image(p) for p in paths]
    jpeg = native_io.read_image(FIXTURE)
    assert native_io.route()[0] == "native"
    monkeypatch.setattr(native_io, "_state", (None, "g++ not found (selected by the test)"))
    name, detail = native_io.route()
    assert name == "stdlib" and detail.startswith("g++ not found (selected by the test); "
                                                  "JPEG: PIL ")
    for p, want in zip(paths, native):
        got = native_io.read_image(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native_io.read_image(FIXTURE), jpeg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert native_io.route()[1].endswith("JPEG: no decoder (PIL is not installed: "
                                         "import of PIL halted; None in sys.modules)")
    with pytest.raises(RuntimeError, match=r"jpeg_968x1296\.jpg: JPEG: no decoder.*PIL"):
        native_io.read_image(FIXTURE)


def test_library_is_built_from_the_source_into_the_build_dir():
    """The route's library is ``_build/libdataio-<hash of source and flags>.so``."""
    from desr_tpu_torch.ops import _build

    name, detail = native_io.route()
    lib = detail.split("; ")[0]
    assert name == "native" and lib == _build.library_path("dataio")
    assert os.path.dirname(lib) == _build.BUILD_DIR and os.path.exists(lib)


def _chunks(data):
    """A PNG's chunks as [kind, body] lists."""
    out, pos = [], 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        out.append([data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]])
        pos += 12 + n
    return out


def _png(chunks):
    """PNG bytes of [kind, body] chunks, their CRCs right: a corrupt body
    reaches the decoder instead of failing the checksum."""
    return b"\x89PNG\r\n\x1a\n" + b"".join(struct.pack(">I", len(b)) + k + b
                               + struct.pack(">I", zlib.crc32(k + b)) for k, b in chunks)


def _with(chunks, kind, fn):
    return [[k, fn(b) if k == kind else b] for k, b in chunks]


def _segments(data):
    """A JPEG's marker segments before its first scan's data, as
    (marker byte, offset of the body, body length)."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        marker, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, pos + 4, n - 2))
        if marker == 0xDA:
            break
        pos += 2 + n
    return out


def _patch_segment(data, marker, fn, nth=0):
    """``data`` with the ``nth`` segment of ``marker`` replaced by ``fn(body)``."""
    seg = [s for s in _segments(data) if s[0] == marker][nth]
    body = fn(bytearray(data[seg[1]:seg[1] + seg[2]]))
    return (data[:seg[1] - 2] + struct.pack(">H", len(body) + 2) + bytes(body)
            + data[seg[1] + seg[2]:])


def _dht_overfull(body):  # 200 codes of length 1, where 2 fit (libjpeg: bogus Huffman table)
    return bytearray([body[0], 200] + [0] * 15 + list(range(200)))


def _sos_many_components(body):  # Ns = 255 (libjpeg takes 1..4)
    return bytearray([255]) + body[1:]


def _sos_band_past_63(body):  # spectral selection Ss..Se = 0..200 (libjpeg: at most 63)
    body[-3], body[-2] = 0, 200  # an error in a progressive scan; a sequential one ignores it
    return body


def _sof_zero_width(body):
    body[3:5] = b"\x00\x00"
    return body


def _malformed_pngs(tmp_path):
    rgb, pal = tmp_path / "rgb.png", tmp_path / "pal.png"
    _write_png(rgb, "rgb8", (40, 56), 7)
    _write_png(pal, "palette", (40, 56), 7)
    rgb_b, pal_b = rgb.read_bytes(), pal.read_bytes()
    c, p = _chunks(rgb_b), _chunks(pal_b)
    ihdr = lambda w, h, d=8, t=2: lambda b: struct.pack(">II", w, h) + bytes([d, t]) + b[10:]
    return {
        "truncated_header": rgb_b[:30],
        "truncated_idat": rgb_b[:len(rgb_b) // 2],
        "chunk_past_the_end": rgb_b[:8] + struct.pack(">I", 1 << 31) + rgb_b[12:],
        "huge_size_small_idat": _png(_with(c, b"IHDR", ihdr(1000000, 1000000))),
        "side_past_libpng_limit": _png(_with(c, b"IHDR", ihdr(1 << 30, 1))),
        "negative_height": _png(_with(c, b"IHDR", ihdr(56, 1 << 31))),
        "bad_bit_depth": _png(_with(c, b"IHDR", ihdr(56, 40, 3))),
        "bad_colour_type": _png(_with(c, b"IHDR", ihdr(56, 40, 8, 5))),
        "rows_longer_than_idat": _png(_with(c, b"IHDR", ihdr(57, 40))),
        "bad_filter_byte": _png(_with(c, b"IDAT", lambda b: zlib.compress(
            b"\x09" + zlib.decompress(b)[1:]))),
        "idat_not_deflate": _png(_with(c, b"IDAT", lambda b: b"\xff" * len(b))),
        "empty_palette": _png(_with(p, b"PLTE", lambda b: b"")),
        "palette_over_256": _png(_with(p, b"PLTE", lambda b: b * 20)),
        "palette_without_plte": _png([[k, b] for k, b in p if k != b"PLTE"]),
    }


def _malformed_jpegs():
    data = open(FIXTURE, "rb").read()
    ok, progressive = cv2.imencode(".jpg", _scene((40, 56), 3), JPEG_CASES["progressive"])
    progressive = progressive.tobytes()
    return {
        "truncated_header": data[:300],
        "truncated_scan": data[:len(data) // 2],
        "dht_overfull": _patch_segment(data, 0xC4, _dht_overfull),
        "sos_many_components": _patch_segment(data, 0xDA, _sos_many_components),
        "progressive_sos_band_past_63": _patch_segment(progressive, 0xDA, _sos_band_past_63),
        "sof_zero_width": _patch_segment(data, 0xC0, _sof_zero_width),
    }


def test_malformed_files_raise_value_error(tmp_path, monkeypatch):
    """Corrupt and truncated PNGs (header fields, chunk lengths, palette,
    the deflate stream and the filter bytes, CRCs kept right) and JPEGs
    (DHT, SOS and SOF segments, truncation) raise ValueError naming the
    file: no crash, no read or write out of bounds. PIL's default of
    refusing truncated files is set here: the JAX package's load_image turns
    it off process-wide."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", False)
    assert native_io.route()[0] == "native"
    cases = {f"png_{k}": v for k, v in _malformed_pngs(tmp_path).items()}
    cases.update({f"jpeg_{k}": v for k, v in _malformed_jpegs().items()})
    for name, data in cases.items():
        path = tmp_path / f"{name}.bin"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=rf"{name}\.bin: "):
            native_io.read_image(path)
        if name.startswith("png_"):
            with pytest.raises(ValueError, match=rf"{name}\.bin: "):
                native_io.decode_png(path)


@pytest.mark.parametrize("fmt", ["png_rgb8", "png_palette", "png_grey16", "jpeg"])
def test_flipped_bytes_never_crash(tmp_path, fmt):
    """Prefixes of the header and 300 seeded single-byte flips anywhere in
    the file: each read either raises ValueError or returns a uint8 or
    uint16 array (a flipped header may describe another valid image)."""
    if fmt == "jpeg":
        data = cv2.imencode(".jpg", _scene((48, 64), 3), JPEG_CASES["420"])[1].tobytes()
    else:
        path = tmp_path / "x.png"
        _write_png(path, fmt[4:], (24, 40), 5)
        data = path.read_bytes()
    rng = np.random.default_rng(11)
    variants = [data[:n] for n in range(0, 200, 7)]
    for pos in rng.integers(0, len(data), 300):
        b = bytearray(data)
        b[pos] ^= int(rng.integers(1, 256))
        variants.append(bytes(b))
    path = tmp_path / "v.bin"
    for v in variants:
        path.write_bytes(v)
        try:
            got = native_io.read_image(path)
        except ValueError:
            continue
        assert got.dtype in (np.uint8, np.uint16) and got.ndim in (2, 3)
