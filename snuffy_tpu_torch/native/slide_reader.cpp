// Pyramidal TIFF slide reader with a plain C interface, loaded by ctypes
// from snuffy_tpu_torch/native/__init__.py.
//
// The reading half of snuffy_tpu/native/snuffy_native.cpp (the OpenSlide
// replacement): open a possibly pyramidal TIFF, report its levels, read an
// RGB region of one level, close. The writers, the JPEG encoder and the CSV
// parser of that file are not copied: the slide path of the port does not
// call them.

#include <tiffio.h>

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

void slide_close(void* handle) {
  auto* s = (SlideHandle*)handle;
  if (s->tif) TIFFClose(s->tif);
  delete s;
}

}  // extern "C"
