// C API for ctypes binding (pybind11 is not available in this image; the plain
// C ABI keeps the Python side dependency-free).
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "image_io.h"
#include "overlap.h"

extern "C" {

// Decode a grayscale JPEG resized (bilinear) to out_h x out_w float [0,1].
// Returns 0 on success.
int emvm_load_gray_jpeg(const char* path, float* out, int out_h, int out_w) {
  emvm::Image img;
  if (!emvm::DecodeJpegGray(path, &img)) return 1;
  if (img.h != out_h || img.w != out_w) img = emvm::ResizeBilinear(img, out_h, out_w);
  std::memcpy(out, img.data.data(), sizeof(float) * out_h * out_w);
  return 0;
}

// Query image dimensions without full decode (JPEG header only).
int emvm_jpeg_size(const char* path, int* h, int* w) {
  emvm::Image img;  // full decode fallback -- header-only peek not worth the code
  if (!emvm::DecodeJpegGray(path, &img)) return 1;
  *h = img.h;
  *w = img.w;
  return 0;
}

// Query PNG dimensions (full decode; headers-only not worth the extra code).
int emvm_png_size(const char* path, int* h, int* w) {
  emvm::Image img;
  if (!emvm::DecodeDepthPng16(path, &img)) return 1;
  *h = img.h;
  *w = img.w;
  return 0;
}

// Decode a 16-bit depth PNG (mm -> m) resized (nearest) to out_h x out_w.
int emvm_load_depth_png(const char* path, float* out, int out_h, int out_w) {
  emvm::Image img;
  if (!emvm::DecodeDepthPng16(path, &img)) return 1;
  if (img.h != out_h || img.w != out_w) img = emvm::ResizeNearest(img, out_h, out_w);
  std::memcpy(out, img.data.data(), sizeof(float) * out_h * out_w);
  return 0;
}

// Threaded tuple-batch loader: n images + n depths into preallocated buffers
// shaped (n, out_h, out_w). Returns the number of failed loads.
int emvm_load_batch(const char** rgb_paths, const char** depth_paths, int n,
                    int out_h, int out_w, float* images, float* depths,
                    int n_threads) {
  std::vector<int> errors(n, 0);
  std::vector<std::thread> threads;
  const int nt = n_threads > 0 ? n_threads : 1;
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  size_t plane = static_cast<size_t>(out_h) * out_w;
  auto work = [&](int t) {
    for (int i = t; i < n; i += nt) {
      if (rgb_paths && rgb_paths[i] &&
          emvm_load_gray_jpeg(rgb_paths[i], images + plane * i, out_h, out_w) != 0)
        errors[i] = 1;
      if (depth_paths && depth_paths[i] &&
          emvm_load_depth_png(depth_paths[i], depths + plane * i, out_h, out_w) != 0)
        errors[i] = 1;
    }
  };
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  int failed = 0;
  for (int e : errors) failed += e;
  return failed;
}

// Overlap matrix over already-loaded depth frames (see overlap.h).
int emvm_overlap_matrix(const float* depths, const double* poses,
                        const double* intr, int n, int h, int w, int stride,
                        float depth_consistency, float* out, int n_threads) {
  emvm::ComputeOverlapMatrix(depths, poses, intr, n, h, w, stride,
                             depth_consistency, out, n_threads);
  return 0;
}

}  // extern "C"
