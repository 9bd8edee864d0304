// Overlap-graph computation between depth frames of a scene.
//
// The tuple sampler (data/tuples.py) consumes per-scene overlap JSONs
// ({img_id: [candidate ids]}, overlap 0.4-0.8 as the upstream README gives it),
// which the upstream project never ships a generator for. This is it: for
// every ordered frame pair, unproject a subsampled depth grid of view i,
// project into view j, and count the fraction of points that land in-bounds
// with consistent depth; the symmetric mean forms the overlap matrix.
// O(n^2 * HW / stride^2), threaded.
#pragma once

#include <cstdint>
#include <vector>

namespace emvm {

// depths: n * h * w row-major (meters, 0 = invalid)
// poses: n * 16 row-major cam->world 4x4
// intr: n * 9 row-major 3x3 per frame
// out_overlap: n * n symmetric-mean overlap fractions
void ComputeOverlapMatrix(const float* depths, const double* poses,
                          const double* intr, int n, int h, int w, int stride,
                          float depth_consistency, float* out_overlap,
                          int n_threads);

}  // namespace emvm
