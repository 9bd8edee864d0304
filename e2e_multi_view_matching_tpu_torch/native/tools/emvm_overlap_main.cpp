// emvm_overlap: generate per-scene overlap JSONs for a ScanNet-format dataset.
//
// Usage: emvm_overlap <dataset_dir> <split> [min_overlap] [max_overlap] [stride]
//
// Walks <dataset_dir>/scans[_test]/<scene>/{depth,pose,intrinsic}, computes the
// pairwise symmetric overlap matrix (threaded), and writes
// <dataset_dir>/overlap/scans[_test]/<scene>.json with the candidate lists the
// tuple sampler consumes (overlap within [min, max], default 0.4-0.8 per the
// reference README). Fills the preprocessing gap the reference leaves open.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "../src/image_io.h"
#include "../src/overlap.h"

namespace fs = std::filesystem;

static bool ReadMatrixTxt(const std::string& path, int rows, int cols, double* out) {
  std::ifstream f(path);
  if (!f) return false;
  for (int i = 0; i < rows * cols; ++i)
    if (!(f >> out[i])) return false;
  return true;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: emvm_overlap <dataset_dir> <split> [min=0.4] [max=0.8] "
                 "[stride=8]\n");
    return 2;
  }
  const std::string dataset_dir = argv[1];
  const std::string split = argv[2];
  const float min_ov = argc > 3 ? std::stof(argv[3]) : 0.4f;
  const float max_ov = argc > 4 ? std::stof(argv[4]) : 0.8f;
  const int stride = argc > 5 ? std::stoi(argv[5]) : 8;
  const std::string scans = split == "test" ? "scans_test" : "scans";
  const fs::path scans_dir = fs::path(dataset_dir) / scans;
  const fs::path out_dir = fs::path(dataset_dir) / "overlap" / scans;
  fs::create_directories(out_dir);
  const int n_threads = std::max(1u, std::thread::hardware_concurrency());

  for (const auto& scene_entry : fs::directory_iterator(scans_dir)) {
    if (!scene_entry.is_directory()) continue;
    const std::string scene = scene_entry.path().filename().string();
    const fs::path depth_dir = scene_entry.path() / "depth";
    if (!fs::exists(depth_dir)) continue;

    // frame ids = numeric names of depth files
    std::vector<int> ids;
    for (const auto& e : fs::directory_iterator(depth_dir)) {
      std::string stem = e.path().stem().string();
      if (!stem.empty() && std::all_of(stem.begin(), stem.end(), ::isdigit))
        ids.push_back(std::stoi(stem));
    }
    std::sort(ids.begin(), ids.end());
    const int n = static_cast<int>(ids.size());
    if (n < 2) continue;

    // shared (scannet) or per-image intrinsics
    const fs::path shared_intr = scene_entry.path() / "intrinsic" / "intrinsic_color.txt";
    double shared_K[16];
    const bool has_shared = ReadMatrixTxt(shared_intr.string(), 4, 4, shared_K);

    // load depths (resized to the first frame's size if needed) + poses + intr
    emvm::Image first;
    if (!emvm::DecodeDepthPng16((depth_dir / (std::to_string(ids[0]) + ".png")).string(), &first))
      continue;
    const int h = first.h, w = first.w;
    std::vector<float> depths(static_cast<size_t>(n) * h * w);
    std::vector<double> poses(static_cast<size_t>(n) * 16);
    std::vector<double> intr(static_cast<size_t>(n) * 9);
    bool ok = true;
    for (int k = 0; k < n && ok; ++k) {
      emvm::Image d;
      ok = emvm::DecodeDepthPng16(
          (depth_dir / (std::to_string(ids[k]) + ".png")).string(), &d);
      if (!ok) break;
      if (d.h != h || d.w != w) d = emvm::ResizeNearest(d, h, w);
      std::memcpy(depths.data() + static_cast<size_t>(k) * h * w, d.data.data(),
                  sizeof(float) * h * w);
      ok = ReadMatrixTxt(
          (scene_entry.path() / "pose" / (std::to_string(ids[k]) + ".txt")).string(),
          4, 4, poses.data() + static_cast<size_t>(k) * 16);
      if (!ok) break;
      double K16[16];
      if (has_shared) {
        std::memcpy(K16, shared_K, sizeof(K16));
      } else {
        ok = ReadMatrixTxt(
            (scene_entry.path() / "intrinsic" / (std::to_string(ids[k]) + ".txt"))
                .string(), 4, 4, K16);
        if (!ok) break;
      }
      double* Kk = intr.data() + static_cast<size_t>(k) * 9;
      Kk[0] = K16[0]; Kk[1] = K16[1]; Kk[2] = K16[2];
      Kk[3] = K16[4]; Kk[4] = K16[5]; Kk[5] = K16[6];
      Kk[6] = K16[8]; Kk[7] = K16[9]; Kk[8] = K16[10];
    }
    if (!ok) {
      std::fprintf(stderr, "skipping scene %s (read failure)\n", scene.c_str());
      continue;
    }

    std::vector<float> overlap(static_cast<size_t>(n) * n);
    emvm::ComputeOverlapMatrix(depths.data(), poses.data(), intr.data(), n, h, w,
                               stride, 0.1f, overlap.data(), n_threads);

    std::ostringstream js;
    js << "{";
    for (int i = 0; i < n; ++i) {
      js << (i ? ", " : "") << "\"" << ids[i] << "\": [";
      bool firstc = true;
      for (int j = 0; j < n; ++j) {
        if (i == j) continue;
        const float ov = overlap[static_cast<size_t>(i) * n + j];
        if (ov >= min_ov && ov <= max_ov) {
          js << (firstc ? "" : ", ") << ids[j];
          firstc = false;
        }
      }
      js << "]";
    }
    js << "}";
    std::ofstream out(out_dir / (scene + ".json"));
    out << js.str();
    std::printf("scene %s: %d frames, overlap json written\n", scene.c_str(), n);
  }
  return 0;
}
