// Host PNG decode and normalisation for desr_tpu_torch (counterpart of
// native/dataio.cpp), loaded with ctypes by desr_tpu_torch/data/native_io.py.
//
// The card's machine has zlib but not libpng, so the PNG decoder is written
// here on zlib alone (JPEG goes through PIL's libjpeg-turbo, native_io.py):
//
//   - dio_png_info / dio_png: non-interlaced PNGs of every colour type and
//     bit depth, with libpng's expansions as native/dataio.cpp asks for them
//     (palette to RGB, grey below 8 bits scaled to 8, tRNS to an alpha
//     channel); 8-bit samples come out as uint8, 16-bit as host-order uint16.
//     A malformed file returns an error code, never reads or writes out of
//     bounds: chunk lengths are held to the file, the dimensions to libpng's
//     default limit and to what the IDAT bytes can inflate to, the palette
//     to 1..256 entries, and the inflated rows to their exact size.
//   - depth_to_norm, image_to_norm, resize_area_f32: the normalisers and the
//     INTER_AREA box filter of native/dataio.cpp, unchanged.
//
// The decoder takes the file's bytes and returns 0 or a negative code
// (DIO_* below; native_io.py names them). Built by desr_tpu_torch/ops/_build.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o libdataio-<hash>.so dataio.cpp -lz

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum {
  DIO_OK = 0,
  DIO_NOT_THIS_FORMAT = -1,
  DIO_CORRUPT = -2,
  DIO_UNSUPPORTED = -3,
  DIO_CAPACITY = -4,
  DIO_NO_MEMORY = -5,
};

// libpng's default PNG_USER_{WIDTH,HEIGHT}_MAX.
constexpr uint32_t kMaxSide = 1000000;
// deflate's largest ratio of output to input is 1032:1 (zlib's FAQ); more
// pixel bytes than that from the IDAT chunks means a corrupt header.
constexpr int64_t kMaxInflateRatio = 1032;

// ------------------------------------------------------------------ PNG

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct PngHeader {
  int width = 0, height = 0, depth = 0, ctype = 0, interlace = 0;
  int channels_in = 0;   // samples a pixel as stored
  int channels_out = 0;  // after the expansions
  int depth_out = 0;     // 8 or 16
  const uint8_t* plte = nullptr;
  int plte_n = 0;
  const uint8_t* trns = nullptr;
  int trns_n = 0;
  std::vector<const uint8_t*> idat;
  std::vector<uint32_t> idat_n;
  int64_t stride = 0;    // bytes a row holds, without its filter byte
  int64_t raw_bytes = 0;  // the inflated image: height rows of 1 + stride
};

int png_parse(const uint8_t* data, int64_t n, PngHeader* h) {
  if (n < 8 || std::memcmp(data, kPngSig, 8) != 0) return DIO_NOT_THIS_FORMAT;
  int64_t pos = 8;
  bool ihdr = false;
  while (pos + 8 <= n) {
    uint32_t len = be32(data + pos);
    const uint8_t* kind = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + int64_t(len) > n) return DIO_CORRUPT;
    if (!std::memcmp(kind, "IHDR", 4)) {
      if (len < 13) return DIO_CORRUPT;
      h->width = int(be32(body));
      h->height = int(be32(body + 4));
      h->depth = body[8];
      h->ctype = body[9];
      h->interlace = body[12];
      ihdr = true;
    } else if (!std::memcmp(kind, "PLTE", 4)) {
      h->plte = body;
      h->plte_n = int(len / 3);
    } else if (!std::memcmp(kind, "tRNS", 4)) {
      h->trns = body;
      h->trns_n = int(len);
    } else if (!std::memcmp(kind, "IDAT", 4)) {
      h->idat.push_back(body);
      h->idat_n.push_back(len);
    } else if (!std::memcmp(kind, "IEND", 4)) {
      break;
    }
    pos += 12 + int64_t(len);
  }
  if (!ihdr || h->idat.empty()) return DIO_CORRUPT;
  if (h->width <= 0 || h->height <= 0 || uint32_t(h->width) > kMaxSide ||
      uint32_t(h->height) > kMaxSide)
    return DIO_CORRUPT;
  if (h->interlace) return DIO_UNSUPPORTED;
  const int d = h->depth;
  switch (h->ctype) {
    case 0:
      if (d != 1 && d != 2 && d != 4 && d != 8 && d != 16) return DIO_CORRUPT;
      h->channels_in = 1;
      h->channels_out = h->trns ? 2 : 1;
      break;
    case 2:
      if (d != 8 && d != 16) return DIO_CORRUPT;
      h->channels_in = 3;
      h->channels_out = h->trns ? 4 : 3;
      break;
    case 3:
      if (d != 1 && d != 2 && d != 4 && d != 8) return DIO_CORRUPT;
      if (!h->plte || h->plte_n < 1 || h->plte_n > 256) return DIO_CORRUPT;
      h->channels_in = 1;
      h->channels_out = h->trns ? 4 : 3;
      break;
    case 4:
      if (d != 8 && d != 16) return DIO_CORRUPT;
      h->channels_in = 2;
      h->channels_out = 2;
      break;
    case 6:
      if (d != 8 && d != 16) return DIO_CORRUPT;
      h->channels_in = 4;
      h->channels_out = 4;
      break;
    default:
      return DIO_CORRUPT;
  }
  h->depth_out = d == 16 ? 16 : 8;
  h->stride = (int64_t(h->width) * h->channels_in * d + 7) / 8;
  h->raw_bytes = int64_t(h->height) * (h->stride + 1);  // at most 1e6 * 8000001
  int64_t idat_bytes = 0;
  for (uint32_t len : h->idat_n) idat_bytes += len;
  if (h->raw_bytes > kMaxInflateRatio * idat_bytes + 1024) return DIO_CORRUPT;
  // zlib counts its output in 32 bits
  if (h->raw_bytes > int64_t(UINT32_MAX)) return DIO_UNSUPPORTED;
  return DIO_OK;
}

inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  int bc = pb <= pc ? b : c;
  return (pa <= pb && pa <= pc) ? a : bc;
}

// Undo the scanline filters in place; rows are `stride` bytes after a filter byte.
int png_unfilter(uint8_t* raw, int height, int64_t stride, int bpp) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prior = zero.data();
  for (int y = 0; y < height; ++y) {
    uint8_t* row = raw + int64_t(y) * (stride + 1);
    const int f = row[0];
    uint8_t* cur = row + 1;
    switch (f) {
      case 0:
        break;
      case 1:
        for (int64_t i = bpp; i < stride; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) cur[i] = uint8_t(cur[i] + prior[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + ((a + prior[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prior[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + paeth(a, prior[i], c));
        }
        break;
      default:
        return DIO_CORRUPT;
    }
    prior = cur;
  }
  return DIO_OK;
}

int png_decode(const uint8_t* data, int64_t n, void* out, int64_t capacity_bytes) {
  PngHeader h;
  int rc = png_parse(data, n, &h);
  if (rc) return rc;
  const int W = h.width, H = h.height, d = h.depth;
  const int64_t stride = h.stride;
  const int bpp = std::max(1, h.channels_in * d / 8);
  const int64_t out_bytes = int64_t(W) * H * h.channels_out * (h.depth_out / 8);
  if (out_bytes > capacity_bytes) return DIO_CAPACITY;

  std::vector<uint8_t> raw(size_t(h.raw_bytes));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return DIO_CORRUPT;
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zr = Z_OK;
  for (size_t i = 0; i < h.idat.size() && zr != Z_STREAM_END; ++i) {
    zs.next_in = const_cast<Bytef*>(h.idat[i]);
    zs.avail_in = h.idat_n[i];
    while (zs.avail_in > 0 && zs.avail_out > 0) {
      zr = inflate(&zs, Z_NO_FLUSH);
      if (zr == Z_STREAM_END) break;
      if (zr != Z_OK) {
        inflateEnd(&zs);
        return DIO_CORRUPT;
      }
    }
  }
  const bool full = zs.avail_out == 0;
  inflateEnd(&zs);
  if (!full) return DIO_CORRUPT;
  rc = png_unfilter(raw.data(), H, stride, bpp);
  if (rc) return rc;

  const int co = h.channels_out;
  if (d == 16) {
    uint16_t* o = static_cast<uint16_t*>(out);
    const uint16_t tr = h.trns && h.trns_n >= 2 ? uint16_t((h.trns[0] << 8) | h.trns[1]) : 0;
    uint16_t trgb[3] = {0, 0, 0};
    if (h.trns && h.ctype == 2 && h.trns_n >= 6)
      for (int k = 0; k < 3; ++k) trgb[k] = uint16_t((h.trns[2 * k] << 8) | h.trns[2 * k + 1]);
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = raw.data() + int64_t(y) * (stride + 1) + 1;
      uint16_t* dst = o + int64_t(y) * W * co;
      if (co == h.channels_in) {  // no tRNS: the big-endian samples swapped
        const int64_t n = int64_t(W) * co;
        for (int64_t i = 0; i < n; ++i) dst[i] = uint16_t((r[2 * i] << 8) | r[2 * i + 1]);
        continue;
      }
      for (int x = 0; x < W; ++x) {
        uint16_t s[4];
        for (int k = 0; k < h.channels_in; ++k) {
          const uint8_t* p = r + (int64_t(x) * h.channels_in + k) * 2;
          s[k] = uint16_t((p[0] << 8) | p[1]);
        }
        for (int k = 0; k < h.channels_in; ++k) dst[k] = s[k];
        if (co > h.channels_in) {  // tRNS -> alpha
          bool clear = h.ctype == 0 ? s[0] == tr
                                    : (s[0] == trgb[0] && s[1] == trgb[1] && s[2] == trgb[2]);
          dst[h.channels_in] = clear ? 0 : 0xFFFF;
        }
        dst += co;
      }
    }
    return DIO_OK;
  }
  uint8_t* o = static_cast<uint8_t*>(out);
  const int scale = d == 1 ? 255 : d == 2 ? 85 : d == 4 ? 17 : 1;  // libpng's expand
  const int mask = (1 << d) - 1;
  for (int y = 0; y < H; ++y) {
    const uint8_t* r = raw.data() + int64_t(y) * (stride + 1) + 1;
    uint8_t* dst = o + int64_t(y) * W * co;
    if (d == 8 && co == h.channels_in) {  // the common case: a straight copy
      std::memcpy(dst, r, size_t(W) * co);
      continue;
    }
    for (int x = 0; x < W; ++x) {
      if (h.ctype == 3 || (h.ctype == 0 && d < 8) || (h.ctype == 0 && d == 8)) {
        int v;
        if (d == 8) {
          v = r[x];
        } else {
          const int per = 8 / d;
          v = (r[x / per] >> ((per - 1 - x % per) * d)) & mask;
        }
        if (h.ctype == 3) {
          const int idx = v < h.plte_n ? v : 0;
          dst[0] = h.plte[3 * idx];
          dst[1] = h.plte[3 * idx + 1];
          dst[2] = h.plte[3 * idx + 2];
          if (co == 4) dst[3] = v < h.trns_n ? h.trns[v] : 255;
        } else {
          dst[0] = uint8_t(v * scale);
          if (co == 2) {
            const int tr = h.trns_n >= 2 ? (((h.trns[0] << 8) | h.trns[1]) & mask) : -1;
            dst[1] = v == tr ? 0 : 255;
          }
        }
      } else {  // 8-bit RGB with tRNS
        const uint8_t* p = r + int64_t(x) * 3;
        dst[0] = p[0];
        dst[1] = p[1];
        dst[2] = p[2];
        bool clear = h.trns_n >= 6 && p[0] == h.trns[1] && p[1] == h.trns[3] && p[2] == h.trns[5];
        dst[3] = clear ? 0 : 255;
      }
      dst += co;
    }
  }
  return DIO_OK;
}

}  // namespace

extern "C" {

// Fills width, height, channels (after the expansions) and bit depth (8 or 16).
int dio_png_info(const uint8_t* data, int64_t n, int* width, int* height, int* channels,
                 int* bit_depth) {
  PngHeader h;
  int rc;
  try {
    rc = png_parse(data, n, &h);
  } catch (const std::bad_alloc&) {
    return DIO_NO_MEMORY;
  }
  if (rc) return rc;
  *width = h.width;
  *height = h.height;
  *channels = h.channels_out;
  *bit_depth = h.depth_out;
  return DIO_OK;
}

int dio_png(const uint8_t* data, int64_t n, void* out, int64_t capacity_bytes) {
  try {
    return png_decode(data, n, out, capacity_bytes);
  } catch (const std::bad_alloc&) {  // no exception may cross into ctypes
    return DIO_NO_MEMORY;
  }
}

// uint16 depth (mm) -> [-1, 1] float (native/dataio.cpp's depth_to_norm).
void depth_to_norm(const uint16_t* in, float* out, int64_t n, float max_mm) {
  const float inv = 2.0f / max_mm;
  for (int64_t i = 0; i < n; ++i) {
    float d = (float)in[i];
    if (d > max_mm) d = max_mm;
    out[i] = d * inv - 1.0f;
  }
}

// uint8-range values (stored u16) -> [-1, 1] float ((x - 127.5) / 127.5).
void image_to_norm(const uint16_t* in, float* out, int64_t n) {
  const float inv = 1.0f / 127.5f;
  for (int64_t i = 0; i < n; ++i) out[i] = ((float)in[i] - 127.5f) * inv;
}

// INTER_AREA (box filter with fractional coverage) resize, float32 HWC.
void resize_area_f32(const float* in, int in_h, int in_w, int ch, float* out, int out_h,
                     int out_w) {
  const double sy = (double)in_h / out_h;
  const double sx = (double)in_w / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    double y0 = oy * sy, y1 = (oy + 1) * sy;
    int iy0 = (int)y0, iy1 = std::min((int)std::ceil(y1), in_h);
    for (int ox = 0; ox < out_w; ++ox) {
      double x0 = ox * sx, x1 = (ox + 1) * sx;
      int ix0 = (int)x0, ix1 = std::min((int)std::ceil(x1), in_w);
      for (int c = 0; c < ch; ++c) {
        double acc = 0.0, wsum = 0.0;
        for (int iy = iy0; iy < iy1; ++iy) {
          double wy = std::min((double)iy + 1, y1) - std::max((double)iy, y0);
          for (int ix = ix0; ix < ix1; ++ix) {
            double wx = std::min((double)ix + 1, x1) - std::max((double)ix, x0);
            acc += in[((size_t)iy * in_w + ix) * ch + c] * wy * wx;
            wsum += wy * wx;
          }
        }
        out[((size_t)oy * out_w + ox) * ch + c] = (float)(acc / wsum);
      }
    }
  }
}

}  // extern "C"
