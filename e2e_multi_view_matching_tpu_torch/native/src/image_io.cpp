#include "image_io.h"

#include <jpeglib.h>
#include <png.h>

#include <cstdio>
#include <cstring>

namespace emvm {

bool DecodeJpegGray(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  // let libjpeg do the RGB->gray conversion (ITU-R 601, matching
  // torchvision/cv2 grayscale)
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->data.resize(static_cast<size_t>(out->h) * out->w);
  std::vector<unsigned char> row(out->w);
  unsigned char* rowptr = row.data();
  for (int y = 0; y < out->h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    float* dst = out->data.data() + static_cast<size_t>(y) * out->w;
    for (int x = 0; x < out->w; ++x) dst[x] = row[x] * (1.0f / 255.0f);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

bool DecodeDepthPng16(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(f);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);
  if (color_type != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  out->data.resize(static_cast<size_t>(out->h) * out->w);
  if (bit_depth == 16) {
    // PNG stores 16-bit big-endian; swap to host order
    png_set_swap(png);
    std::vector<uint16_t> row(out->w);
    for (int y = 0; y < out->h; ++y) {
      png_read_row(png, reinterpret_cast<png_bytep>(row.data()), nullptr);
      float* dst = out->data.data() + static_cast<size_t>(y) * out->w;
      for (int x = 0; x < out->w; ++x) dst[x] = row[x] * 1e-3f;  // mm -> m
    }
  } else {
    std::vector<uint8_t> row(out->w);
    for (int y = 0; y < out->h; ++y) {
      png_read_row(png, row.data(), nullptr);
      float* dst = out->data.data() + static_cast<size_t>(y) * out->w;
      for (int x = 0; x < out->w; ++x) dst[x] = row[x] * 1e-3f;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

Image ResizeBilinear(const Image& src, int out_h, int out_w) {
  Image dst;
  dst.h = out_h;
  dst.w = out_w;
  dst.data.resize(static_cast<size_t>(out_h) * out_w);
  const float sy = static_cast<float>(src.h) / out_h;
  const float sx = static_cast<float>(src.w) / out_w;
  for (int y = 0; y < out_h; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(fy);
    if (y0 < 0) y0 = 0;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    const float wy = fy - y0 < 0 ? 0 : fy - y0;
    for (int x = 0; x < out_w; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(fx);
      if (x0 < 0) x0 = 0;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      const float wx = fx - x0 < 0 ? 0 : fx - x0;
      const float a = src.data[static_cast<size_t>(y0) * src.w + x0];
      const float b = src.data[static_cast<size_t>(y0) * src.w + x1];
      const float c = src.data[static_cast<size_t>(y1) * src.w + x0];
      const float d = src.data[static_cast<size_t>(y1) * src.w + x1];
      dst.data[static_cast<size_t>(y) * out_w + x] =
          a * (1 - wx) * (1 - wy) + b * wx * (1 - wy) + c * (1 - wx) * wy + d * wx * wy;
    }
  }
  return dst;
}

Image ResizeNearest(const Image& src, int out_h, int out_w) {
  Image dst;
  dst.h = out_h;
  dst.w = out_w;
  dst.data.resize(static_cast<size_t>(out_h) * out_w);
  for (int y = 0; y < out_h; ++y) {
    int sy = static_cast<int>(static_cast<int64_t>(y) * src.h / out_h);
    for (int x = 0; x < out_w; ++x) {
      int sx = static_cast<int>(static_cast<int64_t>(x) * src.w / out_w);
      dst.data[static_cast<size_t>(y) * out_w + x] =
          src.data[static_cast<size_t>(sy) * src.w + sx];
    }
  }
  return dst;
}

}  // namespace emvm
