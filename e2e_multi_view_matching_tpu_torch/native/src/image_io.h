// Native image IO for the host data pipeline: grayscale JPEG decode and 16-bit
// PNG depth decode with bilinear/nearest resize, in process on threads and
// bound through ctypes (data/native_loader.py). The port's copy of the JAX
// package's native/src: the same code, so both libraries give the same bits.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace emvm {

struct Image {
  int h = 0;
  int w = 0;
  std::vector<float> data;  // row-major, single channel
};

// Decode a JPEG to grayscale float in [0, 1] (ITU-R 601 luma for color files).
bool DecodeJpegGray(const std::string& path, Image* out);

// Decode a 16-bit grayscale PNG storing millimeters; output meters.
bool DecodeDepthPng16(const std::string& path, Image* out);

// Bilinear resize (images) and nearest resize (depth maps).
Image ResizeBilinear(const Image& src, int out_h, int out_w);
Image ResizeNearest(const Image& src, int out_h, int out_w);

}  // namespace emvm
