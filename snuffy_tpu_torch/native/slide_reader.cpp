// Pyramidal TIFF slide reader and JPEG codec with a plain C interface,
// loaded by ctypes from snuffy_tpu_torch/native/__init__.py.
//
// The port's copy of snuffy_tpu/native/snuffy_native.cpp's slide half:
// open a (possibly pyramidal) TIFF, report its levels, read an RGB region;
// decode an aligned block of grid tiles with their edge energies
// (slide_read_grid), or, for JPEG-tiled levels, straight at an M/8 scale
// through libjpeg's scaled IDCT (slide_read_grid_jpeg_scaled); write tiled
// TIFFs and JPEGs for fixtures; and decode a JPEG file as the extraction
// pipeline reads its tiles (jpeg_decode_rgb, in place of PIL); and parse
// a bag's feature CSV (parse_float_csv, the training loaders' parser); and
// the label-plane half: read a mask's class ids (slide_read_label_region),
// each page's spacing from its resolution tags (slide_page_spacing_um),
// and write lossless single-channel label TIFFs (tiff_write_tiled_gray),
// which the FROC masks, the ROI contours and the mask fixtures use.
//
// libtiff and libjpeg (ABI 62) are declared in codec_abi.h, not included
// from their headers, which a machine may lack.

#include "codec_abi.h"

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// --------------------------------------------------------------- TIFF slides

struct SlideHandle {
  TIFF* tif = nullptr;
  std::vector<uint32_t> widths;
  std::vector<uint32_t> heights;
  double spacing_um = 0.0;  // level-0 microns per pixel (0 = unknown)
  // full-level RGBA cache for strip-layout levels (re-reading the whole
  // level per region request would be quadratic in tile count)
  int cached_level = -1;
  std::vector<uint32_t> cache;
};

// Open a (possibly pyramidal) TIFF. Returns an opaque handle or null.
void* slide_open(const char* path) {
  TIFF* tif = TIFFOpen(path, "r");
  if (!tif) return nullptr;
  auto* h = new SlideHandle();
  h->tif = tif;
  do {
    uint32_t w = 0, ht = 0;
    TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &w);
    TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &ht);
    h->widths.push_back(w);
    h->heights.push_back(ht);
  } while (TIFFReadDirectory(tif));
  TIFFSetDirectory(tif, 0);
  float xres = 0.f;
  uint16_t unit = RESUNIT_INCH;
  if (TIFFGetField(tif, TIFFTAG_XRESOLUTION, &xres) && xres > 0.f) {
    TIFFGetFieldDefaulted(tif, TIFFTAG_RESOLUTIONUNIT, &unit);
    double um_per_unit = (unit == RESUNIT_CENTIMETER) ? 10000.0 : 25400.0;
    h->spacing_um = um_per_unit / xres;
  }
  return h;
}

int slide_level_count(void* handle) {
  return (int)((SlideHandle*)handle)->widths.size();
}

void slide_level_dimensions(void* handle, int level, uint32_t* w, uint32_t* h) {
  auto* s = (SlideHandle*)handle;
  *w = s->widths[level];
  *h = s->heights[level];
}

double slide_level_downsample(void* handle, int level) {
  auto* s = (SlideHandle*)handle;
  return (double)s->widths[0] / (double)s->widths[level];
}

double slide_spacing_um(void* handle) {
  return ((SlideHandle*)handle)->spacing_um;
}

// Read a (w × h) RGB region at `level`, top-left (x, y) in level coords.
// out must hold w*h*3 bytes. Returns 0 on success.
int slide_read_region(void* handle, int level, uint32_t x, uint32_t y,
                      uint32_t w, uint32_t h, uint8_t* out) {
  auto* s = (SlideHandle*)handle;
  if (!TIFFSetDirectory(s->tif, level)) return -1;
  TIFF* tif = s->tif;
  uint32_t lw = s->widths[level], lh = s->heights[level];

  // RGBA full-level read is simple + correct for both strip and tile
  // layouts; for large level-0 reads use the tiled path below.
  uint32_t tile_w = 0, tile_h = 0;
  bool tiled = TIFFIsTiled(tif) &&
               TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tile_w) &&
               TIFFGetField(tif, TIFFTAG_TILELENGTH, &tile_h);

  if (tiled) {
    std::vector<uint32_t> tile(tile_w * tile_h);
    for (uint32_t ty = (y / tile_h) * tile_h; ty < y + h && ty < lh;
         ty += tile_h) {
      for (uint32_t tx = (x / tile_w) * tile_w; tx < x + w && tx < lw;
           tx += tile_w) {
        if (!TIFFReadRGBATile(tif, tx, ty, tile.data())) return -2;
        // RGBA tile rows are bottom-up; flip while copying the overlap.
        for (uint32_t ry = 0; ry < tile_h; ++ry) {
          uint32_t gy = ty + ry;
          if (gy < y || gy >= y + h || gy >= lh) continue;
          const uint32_t* src = tile.data() + (tile_h - 1 - ry) * tile_w;
          for (uint32_t rx = 0; rx < tile_w; ++rx) {
            uint32_t gx = tx + rx;
            if (gx < x || gx >= x + w || gx >= lw) continue;
            uint32_t px = src[rx];
            uint8_t* dst = out + ((gy - y) * (size_t)w + (gx - x)) * 3;
            dst[0] = TIFFGetR(px);
            dst[1] = TIFFGetG(px);
            dst[2] = TIFFGetB(px);
          }
        }
      }
    }
    return 0;
  }

  // Strip layout: decode the whole level once and cache it on the handle.
  if (s->cached_level != level) {
    s->cache.assign((size_t)lw * lh, 0);
    if (!TIFFReadRGBAImageOriented(tif, lw, lh, s->cache.data(),
                                   ORIENTATION_TOPLEFT, 0)) {
      s->cached_level = -1;
      return -3;
    }
    s->cached_level = level;
  }
  const uint32_t* full = s->cache.data();
  for (uint32_t ry = 0; ry < h; ++ry) {
    uint32_t gy = y + ry;
    if (gy >= lh) break;
    for (uint32_t rx = 0; rx < w; ++rx) {
      uint32_t gx = x + rx;
      if (gx >= lw) break;
      uint32_t px = full[(size_t)gy * lw + gx];
      uint8_t* dst = out + ((size_t)ry * w + rx) * 3;
      dst[0] = TIFFGetR(px);
      dst[1] = TIFFGetG(px);
      dst[2] = TIFFGetB(px);
    }
  }
  return 0;
}

// Label masks store the class id in the red channel; convenience single-
// channel read (ASAP getUCharPatch equivalent).
int slide_read_label_region(void* handle, int level, uint32_t x, uint32_t y,
                            uint32_t w, uint32_t h, uint8_t* out) {
  std::vector<uint8_t> rgb((size_t)w * h * 3);
  int rc = slide_read_region(handle, level, x, y, w, h, rgb.data());
  if (rc != 0) return rc;
  for (size_t i = 0; i < (size_t)w * h; ++i) out[i] = rgb[i * 3];
  return 0;
}

// Per-page spacing in µm/px from that page's resolution tags (0 when the
// page has none), as ASAP exposes getSpacing per level.
double slide_page_spacing_um(void* handle, int level) {
  auto* s = (SlideHandle*)handle;
  if (!TIFFSetDirectory(s->tif, level)) return 0.0;
  float xres = 0.f;
  uint16_t unit = RESUNIT_INCH;
  double out = 0.0;
  if (TIFFGetField(s->tif, TIFFTAG_XRESOLUTION, &xres) && xres > 0.f) {
    TIFFGetFieldDefaulted(s->tif, TIFFTAG_RESOLUTIONUNIT, &unit);
    double um_per_unit = (unit == RESUNIT_CENTIMETER) ? 10000.0 : 25400.0;
    out = um_per_unit / xres;
  }
  TIFFSetDirectory(s->tif, 0);
  return out;
}

void slide_close(void* handle) {
  auto* s = (SlideHandle*)handle;
  if (s->tif) TIFFClose(s->tif);
  delete s;
}

// Mean |8-neighbour Laplacian| of the grayscale tile with reflect-101
// borders: the background filter of the tiler (reference
// deepzoom_tiler_camelyon16.py:81-85), computed as cv2.filter2D of
// cv2.cvtColor(RGB2GRAY) computes it; tiling/deepzoom.edge_energy is its
// numpy twin. The sums are integers below 2^24, so exact in f32.
static float tile_edge_energy(const uint8_t* rgb, uint32_t n) {
  // Gray into an (n+2)² buffer with reflect-101 edges, so the Laplacian
  // loops below are branch-free and auto-vectorize. Scratch is
  // thread_local: a fresh 0.5 MB malloc per tile costs more in page
  // faults than the arithmetic itself at 10k tiles/slide.
  const uint32_t p = n + 2;
  static thread_local std::vector<float> g, rs;
  g.assign((size_t)p * p, 0.f);
  for (uint32_t y = 0; y < n; ++y) {
    const uint8_t* src = rgb + (size_t)y * n * 3;
    float* dst = g.data() + (size_t)(y + 1) * p + 1;
    // cv2.cvtColor(RGB2GRAY) rounds to uint8 with these exact fixed-point
    // coefficients ((R·9798 + G·19235 + B·3735 + 2^14) >> 15, verified
    // bit-exact against cv2 4.x); keeping float gray here made borderline
    // tiles classify differently between the fused pipeline and the
    // Python tiler that built the bags.
    for (uint32_t x = 0; x < n; ++x)
      dst[x] = (float)((src[x * 3] * 9798u + src[x * 3 + 1] * 19235u +
                        src[x * 3 + 2] * 3735u + 16384u) >> 15);
  }
  for (uint32_t y = 1; y <= n; ++y) {           // reflect-101 columns
    g[(size_t)y * p] = g[(size_t)y * p + 2];
    g[(size_t)y * p + n + 1] = g[(size_t)y * p + n - 1];
  }
  std::memcpy(g.data(), g.data() + 2 * (size_t)p, p * sizeof(float));
  std::memcpy(g.data() + (size_t)(n + 1) * p,
              g.data() + (size_t)(n - 1) * p, p * sizeof(float));
  // |9·g − 3×3 box sum| via separable row sums: rs[x] = g[x−1]+g[x]+g[x+1].
  rs.assign((size_t)p * p, 0.f);
  for (uint32_t y = 0; y < p; ++y) {
    const float* row = g.data() + (size_t)y * p;
    float* out = rs.data() + (size_t)y * p + 1;
    for (uint32_t x = 0; x < n; ++x)
      out[x] = row[x] + row[x + 1] + row[x + 2];
  }
  double acc = 0.0;
  for (uint32_t y = 1; y <= n; ++y) {
    const float* a = rs.data() + (size_t)(y - 1) * p + 1;
    const float* b = rs.data() + (size_t)y * p + 1;
    const float* c = rs.data() + (size_t)(y + 1) * p + 1;
    const float* gg = g.data() + (size_t)y * p + 1;
    float racc = 0.f;
    for (uint32_t x = 0; x < n; ++x) {
      float s = 9.0f * gg[x] - (a[x] + b[x] + c[x]);
      racc += s < 0 ? -s : s;
    }
    acc += racc;
  }
  return (float)(acc / ((double)n * n));
}

// Decode an aligned grid block of n_cols × n_rows tiles of side `read`
// at `level`, starting at grid row `row0`, writing RGB tiles into `out`
// (tile-major, row-scan order: index r*n_cols+c) and the per-tile edge
// energy into `energy`. One call replaces n_cols·n_rows Python
// read_region round trips in the fused inference pipeline (the
// reference's five-stage disk pipeline has no counterpart — tiles go
// JPEG→disk→dataloader there); block-wise calls let the Python caller
// overlap host decode with async device embedding. Returns 0 on success.
int slide_read_grid(void* handle, int level, uint32_t read, uint32_t row0,
                    uint32_t n_cols, uint32_t n_rows, uint8_t* out,
                    float* energy) {
  auto* s = (SlideHandle*)handle;
  if (!TIFFSetDirectory(s->tif, level)) return -1;
  TIFF* tif = s->tif;
  uint32_t tile_w = 0, tile_h = 0;
  bool aligned = TIFFIsTiled(tif) &&
                 TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tile_w) &&
                 TIFFGetField(tif, TIFFTAG_TILELENGTH, &tile_h) &&
                 tile_w == read && tile_h == read;
  // 8-bit contiguous RGB (or YCbCr-JPEG, which libtiff converts when
  // JPEGCOLORMODE_RGB is set) decodes straight into the caller's buffer
  // top-down via TIFFReadEncodedTile — no RGBA pack, no row flip. That
  // halves per-tile copy work vs the TIFFReadRGBATile path.
  uint16_t spp = 0, bps = 0, planar = 0, photo = 0;
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photo);
  bool direct = aligned && spp == 3 && bps == 8 &&
                planar == PLANARCONFIG_CONTIG &&
                (photo == PHOTOMETRIC_RGB || photo == PHOTOMETRIC_YCBCR);
  if (direct && photo == PHOTOMETRIC_YCBCR)
    TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
  const size_t tile_bytes = (size_t)read * read * 3;
  std::vector<uint32_t> rgba;
  if (aligned && !direct) rgba.resize((size_t)read * read);
  for (uint32_t r = 0; r < n_rows; ++r) {
    for (uint32_t c = 0; c < n_cols; ++c) {
      uint8_t* dst = out + ((size_t)r * n_cols + c) * tile_bytes;
      if (direct) {
        ttile_t t = TIFFComputeTile(tif, c * read, (row0 + r) * read, 0, 0);
        if (TIFFReadEncodedTile(tif, t, dst, tile_bytes) < 0) return -2;
      } else if (aligned) {
        if (!TIFFReadRGBATile(tif, c * read, (row0 + r) * read, rgba.data()))
          return -2;
        // RGBA rows are bottom-up; flip + drop alpha in one pass.
        for (uint32_t y = 0; y < read; ++y) {
          const uint32_t* src = rgba.data() + (size_t)(read - 1 - y) * read;
          uint8_t* row = dst + (size_t)y * read * 3;
          for (uint32_t x = 0; x < read; ++x) {
            uint32_t px = src[x];
            row[x * 3 + 0] = TIFFGetR(px);
            row[x * 3 + 1] = TIFFGetG(px);
            row[x * 3 + 2] = TIFFGetB(px);
          }
        }
      } else {
        int rc = slide_read_region(handle, level, c * read,
                                   (row0 + r) * read, read, read, dst);
        if (rc != 0) return rc;
        if (!TIFFSetDirectory(s->tif, level)) return -1;
      }
      energy[(size_t)r * n_cols + c] = tile_edge_energy(dst, read);
    }
  }
  return 0;
}

// tile_edge_energy for one caller-owned (n, n, 3) RGB tile.
float tile_edge_energy_rgb(const uint8_t* rgb, uint32_t n) {
  return tile_edge_energy(rgb, n);
}

// Write one tiled-TIFF directory (pyramid level). Call once per level with
// append=0 on the first and append=1 after; data is (h, w, 3) RGB.
// Enables synthetic WSI-scale fixtures and a tiled re-encoder for strip
// sources. Returns 0 on success.
int tiff_write_tiled_rgb(const char* path, const uint8_t* rgb, uint32_t w,
                         uint32_t h, uint32_t tile, int append,
                         int jpeg_quality) {
  TIFF* tif = TIFFOpen(path, append ? "a" : "w");
  if (!tif) return -1;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, w);
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, h);
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 3);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(tif, TIFFTAG_TILEWIDTH, tile);
  TIFFSetField(tif, TIFFTAG_TILELENGTH, tile);
  if (jpeg_quality > 0) {
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
    TIFFSetField(tif, TIFFTAG_JPEGQUALITY, jpeg_quality);
  } else {
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_NONE);
  }
  std::vector<uint8_t> buf((size_t)tile * tile * 3);
  for (uint32_t ty = 0; ty < h; ty += tile) {
    for (uint32_t tx = 0; tx < w; tx += tile) {
      std::fill(buf.begin(), buf.end(), 255);
      for (uint32_t ry = 0; ry < tile && ty + ry < h; ++ry) {
        const uint8_t* src = rgb + ((size_t)(ty + ry) * w + tx) * 3;
        uint32_t count = (tx + tile <= w) ? tile : (w - tx);
        memcpy(buf.data() + (size_t)ry * tile * 3, src, (size_t)count * 3);
      }
      if (TIFFWriteTile(tif, buf.data(), tx, ty, 0, 0) < 0) {
        TIFFClose(tif);
        return -2;
      }
    }
  }
  TIFFWriteDirectory(tif);
  TIFFClose(tif);
  return 0;
}

// Write one single-channel (label/mask) tiled-TIFF directory. Lossless
// (labels must survive byte-exact). `res_per_cm` > 0 writes per-page
// X/YResolution tags in RESUNIT_CENTIMETER, as Camelyon16's mask TIFFs
// carry per-page spacing tags. data is (h, w).
int tiff_write_tiled_gray(const char* path, const uint8_t* gray, uint32_t w,
                          uint32_t h, uint32_t tile, int append,
                          double res_per_cm) {
  TIFF* tif = TIFFOpen(path, append ? "a" : "w");
  if (!tif) return -1;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, w);
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, h);
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 1);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_MINISBLACK);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(tif, TIFFTAG_TILEWIDTH, tile);
  TIFFSetField(tif, TIFFTAG_TILELENGTH, tile);
  TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_NONE);
  if (res_per_cm > 0) {
    TIFFSetField(tif, TIFFTAG_XRESOLUTION, (float)res_per_cm);
    TIFFSetField(tif, TIFFTAG_YRESOLUTION, (float)res_per_cm);
    TIFFSetField(tif, TIFFTAG_RESOLUTIONUNIT, RESUNIT_CENTIMETER);
  }
  std::vector<uint8_t> buf((size_t)tile * tile);
  for (uint32_t ty = 0; ty < h; ty += tile) {
    for (uint32_t tx = 0; tx < w; tx += tile) {
      std::fill(buf.begin(), buf.end(), 0);
      for (uint32_t ry = 0; ry < tile && ty + ry < h; ++ry) {
        const uint8_t* src = gray + (size_t)(ty + ry) * w + tx;
        uint32_t count = (tx + tile <= w) ? tile : (w - tx);
        memcpy(buf.data() + (size_t)ry * tile, src, count);
      }
      if (TIFFWriteTile(tif, buf.data(), tx, ty, 0, 0) < 0) {
        TIFFClose(tif);
        return -2;
      }
    }
  }
  TIFFWriteDirectory(tif);
  TIFFClose(tif);
  return 0;
}

// ------------------------------------------------------------- CSV parsing

// Parse a numeric CSV held in memory (`size` bytes at `data`, followed by
// a NUL) into float32 rows of `max_cols`, as snuffy_native.cpp's
// parse_float_csv parses a file: strtof, one rounding to f32; a cell that
// is not a number parses as 0; an optional header row skipped. Rows past
// max_rows and cells past max_cols are counted, not stored: it returns the
// number of rows and sets *n_cols to the widest row's cell count, so the
// caller refuses a file that does not fit instead of truncating it.
int parse_float_csv(const char* data, long size, float* out, int max_rows,
                    int max_cols, int* n_cols, int skip_header) {
  const char* p = data;
  const char* end = data + size;
  int row = 0, cols = 0;
  if (skip_header) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  while (p < end) {
    if (*p == '\n' || *p == '\r') {
      ++p;
      continue;
    }
    int col = 0;
    while (p < end && *p != '\n') {
      char* next = const_cast<char*>(p);
      float v = strtof(p, &next);
      if (row < max_rows && col < max_cols)
        out[(size_t)row * max_cols + col] = v;
      ++col;
      p = next;
      while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
      if (p < end && *p == ',') ++p;
      while (p < end && *p == '\r') ++p;
    }
    if (p < end) ++p;
    if (col > cols) cols = col;
    ++row;
  }
  *n_cols = cols;
  return row;
}

}  // extern "C"

// ------------------------------------------------------------------ libjpeg

// setjmp-based error handler: a corrupt tile must fail the call, not
// abort the process (libjpeg's default error_exit calls exit()).
namespace {
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(((JpegErr*)cinfo->err)->jb, 1);
}
}  // namespace

// Baseline JPEG of an (h, w, 3) RGB image at `quality`, libjpeg's
// defaults otherwise (4:2:0, ISLOW). Returns 0 on success.
extern "C" int jpeg_write_rgb(const char* path, const uint8_t* rgb, int w,
                              int h, int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -11;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, 1);
  jpeg_start_compress(&cinfo, 1);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(rgb + (size_t)cinfo.next_scanline * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

// Decode a JPEG file to RGB as PIL's Image.open(path).convert("RGB")
// does: libjpeg's defaults (JDCT_ISLOW, fancy upsampling), YCbCr or RGB
// out as RGB, and grayscale replicated into the three channels (libjpeg-
// turbo's gray → RGB conversion). *w and *h get the image's size; `out`
// holds cap_w·cap_h·3 bytes. Returns 0 on success, -14 when the image is
// larger than the capacity (nothing decoded: call again with room for
// *w × *h), -15 for CMYK/YCCK, which PIL converts through its own CMYK
// path, -1 when the file does not open and -11 when libjpeg fails.
extern "C" int jpeg_decode_rgb(const char* path, uint8_t* out,
                               uint32_t cap_w, uint32_t cap_h, uint32_t* w,
                               uint32_t* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -11;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, 1);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  int rc = 0;
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    rc = -15;
  } else if (cinfo.image_width > cap_w || cinfo.image_height > cap_h) {
    rc = -14;
  }
  if (rc == 0) {
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + (size_t)cinfo.output_scanline *
                               cinfo.output_width * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return rc;
}

// ------------------------------------------------- scaled JPEG tile decode

// Complete eligibility test for the scaled-JPEG grid path. Mirrors EVERY
// precondition slide_read_grid_jpeg_scaled enforces (photometric and
// TILEBYTECOUNTS included) so a level passing this pre-check can never
// return -10 at runtime — the Python caller keys its path choice off
// slide_grid_jpeg_scaled_ok alone.
static bool grid_jpeg_eligible(TIFF* tif, uint32_t read) {
  uint16_t comp = 0, spp = 0, bps = 0, planar = 0, photo = 0;
  uint32_t tile_w = 0, tile_h = 0;
  uint64_t* bytecounts = nullptr;
  TIFFGetFieldDefaulted(tif, TIFFTAG_COMPRESSION, &comp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photo);
  return comp == COMPRESSION_JPEG && TIFFIsTiled(tif) &&
         TIFFGetField(tif, TIFFTAG_TILEWIDTH, &tile_w) &&
         TIFFGetField(tif, TIFFTAG_TILELENGTH, &tile_h) &&
         tile_w == read && tile_h == read && spp == 3 && bps == 8 &&
         planar == PLANARCONFIG_CONTIG &&
         (photo == PHOTOMETRIC_RGB || photo == PHOTOMETRIC_YCBCR) &&
         TIFFGetField(tif, TIFFTAG_TILEBYTECOUNTS, &bytecounts) &&
         bytecounts != nullptr;
}

extern "C" int slide_grid_jpeg_scaled_ok(void* handle, int level,
                                         uint32_t read) {
  auto* s = (SlideHandle*)handle;
  if (!TIFFSetDirectory(s->tif, level)) return 0;
  return grid_jpeg_eligible(s->tif, read) ? 1 : 0;
}

// slide_read_grid with each JPEG tile decoded straight at
// out_side = ceil(read·scale_num/8) by libjpeg's scaled IDCT (scale_denom
// 8, 1 ≤ scale_num ≤ 16): the tile's raw bytes and the level's shared
// JPEGTables go to libjpeg, past libtiff's codec, so a 256² tile bound for
// a 224² embedder decodes at 224² (7/8), with no resize after. The energy
// is taken at out_side. Returns 0 on success, -10 when the level is not
// eligible, -11 when libjpeg fails, -12/-2 for a missing or short tile,
// -13 when libjpeg's output size is not out_side.
extern "C" int slide_read_grid_jpeg_scaled(void* handle, int level,
                                           uint32_t read, uint32_t row0,
                                           uint32_t n_cols, uint32_t n_rows,
                                           uint32_t scale_num, uint8_t* out,
                                           float* energy) {
  auto* s = (SlideHandle*)handle;
  if (!TIFFSetDirectory(s->tif, level)) return -1;
  TIFF* tif = s->tif;
  if (!grid_jpeg_eligible(tif, read) || scale_num < 1 || scale_num > 16)
    return -10;
  uint16_t photo = 0;
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photo);
  if (photo != PHOTOMETRIC_RGB && photo != PHOTOMETRIC_YCBCR) return -10;
  uint64_t* bytecounts = nullptr;
  if (!TIFFGetField(tif, TIFFTAG_TILEBYTECOUNTS, &bytecounts)) return -10;
  // The directory-level abbreviated-stream tables (quant+huffman shared by
  // every tile). Loaded into the decompressor ONCE; they persist across
  // jpeg_read_header calls, which is exactly how abbreviated streams work.
  uint32_t jt_count = 0;
  void* jt = nullptr;
  TIFFGetField(tif, TIFFTAG_JPEGTABLES, &jt_count, &jt);

  const uint32_t out_side = (read * scale_num + 7) / 8;
  const size_t out_bytes = (size_t)out_side * out_side * 3;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // `raw` is constructed BEFORE setjmp: a longjmp from a corrupt tile
  // must not cross a live C++ object's initialization (UB + leak); with
  // the buffer already in scope here, the jump lands after construction
  // and the normal return path runs its destructor.
  std::vector<uint8_t> raw;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -11;
  }
  jpeg_create_decompress(&cinfo);
  if (jt && jt_count > 4) {
    jpeg_mem_src(&cinfo, (unsigned char*)jt, jt_count);
    if (jpeg_read_header(&cinfo, 0) != JPEG_HEADER_TABLES_ONLY) {
      jpeg_destroy_decompress(&cinfo);
      return -11;
    }
  }

  for (uint32_t r = 0; r < n_rows; ++r) {
    for (uint32_t c = 0; c < n_cols; ++c) {
      ttile_t t = TIFFComputeTile(tif, c * read, (row0 + r) * read, 0, 0);
      tmsize_t nbytes = (tmsize_t)bytecounts[t];
      if (nbytes <= 0) {
        jpeg_destroy_decompress(&cinfo);
        return -12;
      }
      raw.resize((size_t)nbytes);
      if (TIFFReadRawTile(tif, t, raw.data(), nbytes) != nbytes) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
      }
      jpeg_mem_src(&cinfo, raw.data(), (unsigned long)nbytes);
      jpeg_read_header(&cinfo, 1);
      // Abbreviated tile streams carry no JFIF/Adobe markers; pin the
      // source space from the TIFF photometric instead of libjpeg's
      // component-id guess (libtiff-written RGB streams tag components
      // 'R','G','B' so the guess usually agrees — usually).
      cinfo.jpeg_color_space =
          (photo == PHOTOMETRIC_YCBCR) ? JCS_YCbCr : JCS_RGB;
      cinfo.out_color_space = JCS_RGB;
      cinfo.scale_num = scale_num;
      cinfo.scale_denom = 8;
      jpeg_start_decompress(&cinfo);
      if (cinfo.output_width != out_side || cinfo.output_height != out_side ||
          cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -13;
      }
      uint8_t* dst = out + ((size_t)r * n_cols + c) * out_bytes;
      while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = dst + (size_t)cinfo.output_scanline * out_side * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
      }
      jpeg_finish_decompress(&cinfo);
      energy[(size_t)r * n_cols + c] =
          tile_edge_energy(dst, out_side);
    }
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
