#include "overlap.h"

#include <atomic>
#include <cmath>
#include <cstring>
#include <thread>

namespace emvm {
namespace {

struct Mat4 {
  double m[16];
};

Mat4 Inverse(const Mat4& t) {
  // rigid-transform inverse: [R t; 0 1]^-1 = [R^T -R^T t; 0 1]
  Mat4 o;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) o.m[i * 4 + j] = t.m[j * 4 + i];
  for (int i = 0; i < 3; ++i) {
    o.m[i * 4 + 3] = -(o.m[i * 4 + 0] * t.m[3] + o.m[i * 4 + 1] * t.m[7] +
                       o.m[i * 4 + 2] * t.m[11]);
  }
  o.m[12] = o.m[13] = o.m[14] = 0;
  o.m[15] = 1;
  return o;
}

Mat4 Mul(const Mat4& a, const Mat4& b) {
  Mat4 o;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.m[i * 4 + k] * b.m[k * 4 + j];
      o.m[i * 4 + j] = s;
    }
  return o;
}

// directed overlap: fraction of valid view-i samples visible in view j
float DirectedOverlap(const float* di, const float* dj, const Mat4& T_i2j,
                      const double* Ki, const double* Kj, int h, int w,
                      int stride, float depth_consistency) {
  const double fx_i = Ki[0], fy_i = Ki[4], cx_i = Ki[2], cy_i = Ki[5];
  const double fx_j = Kj[0], fy_j = Kj[4], cx_j = Kj[2], cy_j = Kj[5];
  int total = 0, hits = 0;
  for (int y = 0; y < h; y += stride) {
    for (int x = 0; x < w; x += stride) {
      const float d = di[static_cast<size_t>(y) * w + x];
      if (d <= 1e-6f) continue;
      ++total;
      const double X = (x - cx_i) / fx_i * d;
      const double Y = (y - cy_i) / fy_i * d;
      const double Z = d;
      const double Xj = T_i2j.m[0] * X + T_i2j.m[1] * Y + T_i2j.m[2] * Z + T_i2j.m[3];
      const double Yj = T_i2j.m[4] * X + T_i2j.m[5] * Y + T_i2j.m[6] * Z + T_i2j.m[7];
      const double Zj = T_i2j.m[8] * X + T_i2j.m[9] * Y + T_i2j.m[10] * Z + T_i2j.m[11];
      if (Zj <= 1e-6) continue;
      const int u = static_cast<int>(fx_j * Xj / Zj + cx_j + 0.5);
      const int v = static_cast<int>(fy_j * Yj / Zj + cy_j + 0.5);
      if (u < 0 || u >= w || v < 0 || v >= h) continue;
      const float dz = dj[static_cast<size_t>(v) * w + u];
      if (dz <= 1e-6f) continue;
      if (std::fabs(dz - Zj) / dz < depth_consistency) ++hits;
    }
  }
  return total > 0 ? static_cast<float>(hits) / total : 0.0f;
}

}  // namespace

void ComputeOverlapMatrix(const float* depths, const double* poses,
                          const double* intr, int n, int h, int w, int stride,
                          float depth_consistency, float* out_overlap,
                          int n_threads) {
  std::vector<Mat4> world_to_cam(n);
  for (int i = 0; i < n; ++i) {
    Mat4 cam_to_world;
    std::memcpy(cam_to_world.m, poses + static_cast<size_t>(i) * 16, sizeof(cam_to_world.m));
    world_to_cam[i] = Inverse(cam_to_world);
  }
  std::vector<Mat4> cam_to_world(n);
  for (int i = 0; i < n; ++i)
    std::memcpy(cam_to_world[i].m, poses + static_cast<size_t>(i) * 16, 16 * sizeof(double));

  // directed overlaps for all ordered pairs, threaded over i
  std::vector<float> directed(static_cast<size_t>(n) * n, 0.0f);
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      const float* di = depths + static_cast<size_t>(i) * h * w;
      for (int j = 0; j < n; ++j) {
        if (i == j) continue;
        const Mat4 T_i2j = Mul(world_to_cam[j], cam_to_world[i]);
        directed[static_cast<size_t>(i) * n + j] = DirectedOverlap(
            di, depths + static_cast<size_t>(j) * h * w, T_i2j,
            intr + static_cast<size_t>(i) * 9, intr + static_cast<size_t>(j) * 9,
            h, w, stride, depth_consistency);
      }
    }
  };
  std::vector<std::thread> threads;
  const int nt = n_threads > 0 ? n_threads : 1;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      out_overlap[static_cast<size_t>(i) * n + j] =
          0.5f * (directed[static_cast<size_t>(i) * n + j] +
                  directed[static_cast<size_t>(j) * n + i]);
}

}  // namespace emvm
