// The parts of libtiff 4.x and of libjpeg's ABI 62 (libjpeg 6b, as
// libjpeg-turbo keeps it for libjpeg.so.62) that slide_reader.cpp calls.
//
// A machine may carry the runtime libraries without their headers: a
// Python wheel's bundled copies, say. So the reader declares what it uses
// here and never includes tiffio.h or jpeglib.h. libtiff is C over an
// opaque TIFF*, and these are its prototypes and tag numbers. libjpeg's
// structs are public and frozen for ABI 62; jpeg_CreateCompress and
// jpeg_CreateDecompress refuse a struct whose size or version differ from
// the library's own, and tests/test_torch_slide.py holds every size,
// offset and constant here to the system headers where they exist.
//
// With SNUFFY_CODEC_ABI_TYPES_ONLY defined, only the types and constants
// are declared (that test includes this file inside a namespace).

#ifndef SNUFFY_TPU_TORCH_CODEC_ABI_H_
#define SNUFFY_TPU_TORCH_CODEC_ABI_H_

#include <cstddef>
#include <cstdint>
#include <cstdio>

// ------------------------------------------------------------------ libtiff

typedef struct tiff TIFF;
typedef int64_t tmsize_t;
typedef uint32_t ttile_t;
typedef uint32_t tdir_t;

enum : uint32_t {
  TIFFTAG_IMAGEWIDTH = 256,
  TIFFTAG_IMAGELENGTH = 257,
  TIFFTAG_BITSPERSAMPLE = 258,
  TIFFTAG_COMPRESSION = 259,
  TIFFTAG_PHOTOMETRIC = 262,
  TIFFTAG_SAMPLESPERPIXEL = 277,
  TIFFTAG_XRESOLUTION = 282,
  TIFFTAG_YRESOLUTION = 283,
  TIFFTAG_PLANARCONFIG = 284,
  TIFFTAG_RESOLUTIONUNIT = 296,
  TIFFTAG_TILEWIDTH = 322,
  TIFFTAG_TILELENGTH = 323,
  TIFFTAG_TILEBYTECOUNTS = 325,
  TIFFTAG_JPEGTABLES = 347,
  TIFFTAG_JPEGQUALITY = 65537,    // pseudo tag of libtiff's JPEG codec
  TIFFTAG_JPEGCOLORMODE = 65538,  // pseudo tag of libtiff's JPEG codec
};
enum : int {
  COMPRESSION_NONE = 1,
  COMPRESSION_JPEG = 7,
  PHOTOMETRIC_MINISBLACK = 1,
  PHOTOMETRIC_RGB = 2,
  PHOTOMETRIC_YCBCR = 6,
  PLANARCONFIG_CONTIG = 1,
  RESUNIT_INCH = 2,
  RESUNIT_CENTIMETER = 3,
  JPEGCOLORMODE_RGB = 1,
  ORIENTATION_TOPLEFT = 1,
};

// The bytes of a packed ABGR pixel of TIFFReadRGBA* (tiffio.h's macros).
inline uint32_t TIFFGetR(uint32_t abgr) { return abgr & 0xff; }
inline uint32_t TIFFGetG(uint32_t abgr) { return (abgr >> 8) & 0xff; }
inline uint32_t TIFFGetB(uint32_t abgr) { return (abgr >> 16) & 0xff; }

#ifndef SNUFFY_CODEC_ABI_TYPES_ONLY
extern "C" {
TIFF* TIFFOpen(const char* path, const char* mode);
void TIFFClose(TIFF* tif);
int TIFFGetField(TIFF* tif, uint32_t tag, ...);
int TIFFGetFieldDefaulted(TIFF* tif, uint32_t tag, ...);
int TIFFSetField(TIFF* tif, uint32_t tag, ...);
int TIFFReadDirectory(TIFF* tif);
int TIFFSetDirectory(TIFF* tif, tdir_t dirn);
int TIFFWriteDirectory(TIFF* tif);
int TIFFIsTiled(TIFF* tif);
uint32_t TIFFComputeTile(TIFF* tif, uint32_t x, uint32_t y, uint32_t z,
                         uint16_t sample);
tmsize_t TIFFReadEncodedTile(TIFF* tif, uint32_t tile, void* buf,
                             tmsize_t size);
tmsize_t TIFFReadRawTile(TIFF* tif, uint32_t tile, void* buf, tmsize_t size);
tmsize_t TIFFWriteTile(TIFF* tif, void* buf, uint32_t x, uint32_t y,
                       uint32_t z, uint16_t sample);
int TIFFReadRGBATile(TIFF* tif, uint32_t x, uint32_t y, uint32_t* raster);
int TIFFReadRGBAImageOriented(TIFF* tif, uint32_t w, uint32_t h,
                              uint32_t* raster, int orientation, int stop);
}  // extern "C"
#endif

// ------------------------------------------------------- libjpeg, ABI 62

typedef int boolean;
typedef unsigned int JDIMENSION;
typedef unsigned char JSAMPLE;
typedef unsigned char JOCTET;
typedef unsigned char UINT8;
typedef unsigned short UINT16;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;

enum { JPEG_LIB_VERSION = 62 };
enum { NUM_QUANT_TBLS = 4, NUM_HUFF_TBLS = 4, NUM_ARITH_TBLS = 16,
       MAX_COMPS_IN_SCAN = 4, C_MAX_BLOCKS_IN_MCU = 10,
       D_MAX_BLOCKS_IN_MCU = 10, DCTSIZE2 = 64 };
enum { JPEG_HEADER_OK = 1, JPEG_HEADER_TABLES_ONLY = 2 };

typedef enum {
  JCS_UNKNOWN, JCS_GRAYSCALE, JCS_RGB, JCS_YCbCr, JCS_CMYK, JCS_YCCK
} J_COLOR_SPACE;
typedef enum { JDCT_ISLOW, JDCT_IFAST, JDCT_FLOAT } J_DCT_METHOD;
typedef enum { JDITHER_NONE, JDITHER_ORDERED, JDITHER_FS } J_DITHER_MODE;

struct JQUANT_TBL_;
struct JHUFF_TBL_;
struct jpeg_component_info_;
struct jpeg_scan_info_;
struct jpeg_marker_struct;

typedef struct jpeg_common_struct* j_common_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo);
  void (*emit_message)(j_common_ptr cinfo, int msg_level);
  void (*output_message)(j_common_ptr cinfo);
  void (*format_message)(j_common_ptr cinfo, char* buffer);
  void (*reset_error_mgr)(j_common_ptr cinfo);
  int msg_code;
  union {
    int i[8];
    char s[80];
  } msg_parm;
  int trace_level;
  long num_warnings;
  const char* const* jpeg_message_table;
  int last_jpeg_message;
  const char* const* addon_message_table;
  int first_addon_message;
  int last_addon_message;
};

#define SNUFFY_JPEG_COMMON_FIELDS    \
  struct jpeg_error_mgr* err;        \
  struct jpeg_memory_mgr* mem;       \
  struct jpeg_progress_mgr* progress; \
  void* client_data;                 \
  boolean is_decompressor;           \
  int global_state

struct jpeg_common_struct {
  SNUFFY_JPEG_COMMON_FIELDS;
};

struct jpeg_compress_struct {
  SNUFFY_JPEG_COMMON_FIELDS;
  struct jpeg_destination_mgr* dest;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int input_components;
  J_COLOR_SPACE in_color_space;
  double input_gamma;
  int data_precision;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;
  jpeg_component_info_* comp_info;
  JQUANT_TBL_* quant_tbl_ptrs[NUM_QUANT_TBLS];
  JHUFF_TBL_* dc_huff_tbl_ptrs[NUM_HUFF_TBLS];
  JHUFF_TBL_* ac_huff_tbl_ptrs[NUM_HUFF_TBLS];
  UINT8 arith_dc_L[NUM_ARITH_TBLS];
  UINT8 arith_dc_U[NUM_ARITH_TBLS];
  UINT8 arith_ac_K[NUM_ARITH_TBLS];
  int num_scans;
  const jpeg_scan_info_* scan_info;
  boolean raw_data_in;
  boolean arith_code;
  boolean optimize_coding;
  boolean CCIR601_sampling;
  int smoothing_factor;
  J_DCT_METHOD dct_method;
  unsigned int restart_interval;
  int restart_in_rows;
  boolean write_JFIF_header;
  UINT8 JFIF_major_version;
  UINT8 JFIF_minor_version;
  UINT8 density_unit;
  UINT16 X_density;
  UINT16 Y_density;
  boolean write_Adobe_marker;
  JDIMENSION next_scanline;
  boolean progressive_mode;
  int max_h_samp_factor;
  int max_v_samp_factor;
  JDIMENSION total_iMCU_rows;
  int comps_in_scan;
  jpeg_component_info_* cur_comp_info[MAX_COMPS_IN_SCAN];
  JDIMENSION MCUs_per_row;
  JDIMENSION MCU_rows_in_scan;
  int blocks_in_MCU;
  int MCU_membership[C_MAX_BLOCKS_IN_MCU];
  int Ss, Se, Ah, Al;
  void* master;
  void* main;
  void* prep;
  void* coef;
  void* marker;
  void* cconvert;
  void* downsample;
  void* fdct;
  void* entropy;
  jpeg_scan_info_* script_space;
  int script_space_size;
};

struct jpeg_decompress_struct {
  SNUFFY_JPEG_COMMON_FIELDS;
  struct jpeg_source_mgr* src;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;
  J_COLOR_SPACE out_color_space;
  unsigned int scale_num, scale_denom;
  double output_gamma;
  boolean buffered_image;
  boolean raw_data_out;
  J_DCT_METHOD dct_method;
  boolean do_fancy_upsampling;
  boolean do_block_smoothing;
  boolean quantize_colors;
  J_DITHER_MODE dither_mode;
  boolean two_pass_quantize;
  int desired_number_of_colors;
  boolean enable_1pass_quant;
  boolean enable_external_quant;
  boolean enable_2pass_quant;
  JDIMENSION output_width;
  JDIMENSION output_height;
  int out_color_components;
  int output_components;
  int rec_outbuf_height;
  int actual_number_of_colors;
  JSAMPARRAY colormap;
  JDIMENSION output_scanline;
  int input_scan_number;
  JDIMENSION input_iMCU_row;
  int output_scan_number;
  JDIMENSION output_iMCU_row;
  int (*coef_bits)[DCTSIZE2];
  JQUANT_TBL_* quant_tbl_ptrs[NUM_QUANT_TBLS];
  JHUFF_TBL_* dc_huff_tbl_ptrs[NUM_HUFF_TBLS];
  JHUFF_TBL_* ac_huff_tbl_ptrs[NUM_HUFF_TBLS];
  int data_precision;
  jpeg_component_info_* comp_info;
  boolean progressive_mode;
  boolean arith_code;
  UINT8 arith_dc_L[NUM_ARITH_TBLS];
  UINT8 arith_dc_U[NUM_ARITH_TBLS];
  UINT8 arith_ac_K[NUM_ARITH_TBLS];
  unsigned int restart_interval;
  boolean saw_JFIF_marker;
  UINT8 JFIF_major_version;
  UINT8 JFIF_minor_version;
  UINT8 density_unit;
  UINT16 X_density;
  UINT16 Y_density;
  boolean saw_Adobe_marker;
  UINT8 Adobe_transform;
  boolean CCIR601_sampling;
  jpeg_marker_struct* marker_list;
  int max_h_samp_factor;
  int max_v_samp_factor;
  int min_DCT_scaled_size;
  JDIMENSION total_iMCU_rows;
  JSAMPLE* sample_range_limit;
  int comps_in_scan;
  jpeg_component_info_* cur_comp_info[MAX_COMPS_IN_SCAN];
  JDIMENSION MCUs_per_row;
  JDIMENSION MCU_rows_in_scan;
  int blocks_in_MCU;
  int MCU_membership[D_MAX_BLOCKS_IN_MCU];
  int Ss, Se, Ah, Al;
  int unread_marker;
  void* master;
  void* main;
  void* coef;
  void* post;
  void* inputctl;
  void* marker;
  void* entropy;
  void* idct;
  void* upsample;
  void* cconvert;
  void* cquantize;
};

#undef SNUFFY_JPEG_COMMON_FIELDS

typedef struct jpeg_compress_struct* j_compress_ptr;
typedef struct jpeg_decompress_struct* j_decompress_ptr;

#ifndef SNUFFY_CODEC_ABI_TYPES_ONLY
extern "C" {
struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err);
void jpeg_CreateCompress(j_compress_ptr cinfo, int version, size_t size);
void jpeg_CreateDecompress(j_decompress_ptr cinfo, int version, size_t size);
void jpeg_destroy_compress(j_compress_ptr cinfo);
void jpeg_destroy_decompress(j_decompress_ptr cinfo);
void jpeg_stdio_dest(j_compress_ptr cinfo, FILE* outfile);
void jpeg_stdio_src(j_decompress_ptr cinfo, FILE* infile);
void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* buffer,
                  unsigned long size);
void jpeg_set_defaults(j_compress_ptr cinfo);
void jpeg_set_quality(j_compress_ptr cinfo, int quality,
                      boolean force_baseline);
void jpeg_start_compress(j_compress_ptr cinfo, boolean write_all_tables);
JDIMENSION jpeg_write_scanlines(j_compress_ptr cinfo, JSAMPARRAY scanlines,
                                JDIMENSION num_lines);
void jpeg_finish_compress(j_compress_ptr cinfo);
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY scanlines,
                               JDIMENSION max_lines);
boolean jpeg_finish_decompress(j_decompress_ptr cinfo);
}  // extern "C"

inline void jpeg_create_compress(j_compress_ptr cinfo) {
  jpeg_CreateCompress(cinfo, JPEG_LIB_VERSION, sizeof(jpeg_compress_struct));
}
inline void jpeg_create_decompress(j_decompress_ptr cinfo) {
  jpeg_CreateDecompress(cinfo, JPEG_LIB_VERSION,
                        sizeof(jpeg_decompress_struct));
}
#endif

#endif  // SNUFFY_TPU_TORCH_CODEC_ABI_H_
