// The sliding-tile puzzle as device code: the successor of one board under
// one move of the blank.
//
// The device-code twin of stateright_tpu_torch/models/sliding_puzzle.py
// (PuzzleDevice.step), itself the port of examples/sliding_puzzle.py's
// PuzzleDevice.step :155-172.
//
// Lanes (w = R * C, 32 bits each, stored unpacked as JAX stores them):
// the tile of each cell, row by row, the blank 0. Action f moves the blank
// up, down, left or right (f = 0 to 3, the host's order). The blank is the
// first lane that holds 0 (lane 0 when none does, as argmax finds it),
// found by a loop over the lanes. A move off the board is disabled; its
// slot holds what JAX's does, the blank swapped with the clamped cell
// index, and since it is disabled its successor never reaches the visited
// table (wave.cuh sends a disabled slot's dedup fingerprint as the
// sentinel). No boundary, no error lane, no symmetry.

#pragma once

#include <cstdint>

namespace sr {

template <int kR, int kC>
struct SlidingPuzzle {
  static constexpr int kMaxW = kR * kC;
  static constexpr int kMaxWords = kR * kC;
  static constexpr int kMinFanout = 4;

  __host__ __device__ int width() const { return kMaxW; }
  __host__ __device__ int fanout() const { return 4; }

  // Applies move f to the board in v, in place, and returns whether it
  // stays on the board. Each cell's four neighbours (clamped into the
  // board, as the torch and JAX steps clamp the index) are constants, and
  // the blank's cell picks them: a first form that found the neighbour's
  // index at run time (the blank's row and column by division, then a
  // select over the lanes) gave wrong successors from nvcc -O3 for sm_90a
  // (CUDA 12.8: the last lane read and zeroed as well; right at -O0, and
  // with an opaque index still wrong), so no index is computed at run
  // time here.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    int blank = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (!found && v[k] == 0u) {
        blank = k;
        found = true;
      }
    }
    int j = 0;
    bool enabled = false;
#pragma unroll
    for (int b = 0; b < kMaxW; ++b) {
      const int r = b / kC, c = b % kC;
      const int up = b - kC < 0 ? 0 : b - kC;
      const int down = b + kC > kMaxW - 1 ? kMaxW - 1 : b + kC;
      const int left = b - 1 < 0 ? 0 : b - 1;
      const int right = b + 1 > kMaxW - 1 ? kMaxW - 1 : b + 1;
      if (b == blank) {
        j = f == 0 ? up : (f == 1 ? down : (f == 2 ? left : right));
        enabled = f == 0   ? r > 0
                  : f == 1 ? r < kR - 1
                  : f == 2 ? c > 0
                           : c < kC - 1;
      }
    }
    // The tile at j moves to the blank's cell, and j becomes the blank
    // (last, so that j == blank leaves a blank).
    uint32_t tile = 0u;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) tile = k == j ? v[k] : tile;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k)
      v[k] = k == j ? 0u : (k == blank ? tile : v[k]);
    return enabled;
  }

  // No symmetry: the wrapper refuses use_sym for this model.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}
};

}  // namespace sr
