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
// first of the w lanes that holds 0 (lane 0 when none does, as argmax finds
// it), found by a loop over the lanes. A move off the board is disabled;
// its slot holds what JAX's does, the blank swapped with the clamped cell
// index, and since it is disabled its successor never reaches the visited
// table (wave.cuh sends a disabled slot's dedup fingerprint as the
// sentinel). No boundary, no error lane, no symmetry.
//
// The model is a template on its capacity in cells (kCells), the board's
// rows and columns at run time: make() tabulates each cell's four moves
// on the host (the clamped cell a move swaps with, and whether it stays on
// the board), and the table travels in the kernel's parameters.
// with_puzzle picks the least capacity of 4, 6, 9, 12 and 16 cells that
// holds a board, so every board of 2 to 16 cells runs.

#pragma once

#include <cstdint>

namespace sr {

template <int kCells>
struct SlidingPuzzle {
  static constexpr int kMaxW = kCells;
  static constexpr int kMaxWords = kCells;
  static constexpr int kMinFanout = 4;

  int n;  // cells, rows * cols <= kCells
  // Cell b's moves, a byte each (move f in byte f): the cell the blank
  // swaps with (low 5 bits) and 0x80 when the move stays on the board.
  uint32_t moves[kCells];

  // The rows x cols board's table.
  static SlidingPuzzle make(int rows, int cols) {
    SlidingPuzzle m{};
    m.n = rows * cols;
    for (int b = 0; b < m.n && b < kCells; ++b) {
      const int r = b / cols, c = b % cols;
      const int to[4] = {b - cols < 0 ? 0 : b - cols,
                         b + cols > m.n - 1 ? m.n - 1 : b + cols,
                         b - 1 < 0 ? 0 : b - 1,
                         b + 1 > m.n - 1 ? m.n - 1 : b + 1};
      const bool on[4] = {r > 0, r < rows - 1, c > 0, c < cols - 1};
      uint32_t x = 0;
      for (int f = 0; f < 4; ++f)
        x |= (uint32_t)(to[f] | (on[f] ? 0x80 : 0)) << (8 * f);
      m.moves[b] = x;
    }
    return m;
  }

  __host__ __device__ int width() const { return n; }
  __host__ __device__ int fanout() const { return 4; }

  // Applies move f to the board in v, in place, and returns whether it
  // stays on the board. The blank's cell picks its table entry by a
  // select over the cells (every index into v a constant): a first form
  // that found the neighbour's index at run time (the blank's row and
  // column by division, then a select over the lanes) gave wrong
  // successors from nvcc -O3 for sm_90a (CUDA 12.8: the last lane read and
  // zeroed as well; right at -O0, and with an opaque index still wrong).
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    int blank = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < n && !found && v[k] == 0u) {
        blank = k;
        found = true;
      }
    }
    uint32_t code = 0;
#pragma unroll
    for (int b = 0; b < kMaxW; ++b)
      if (b == blank) code = moves[b];
    const uint32_t move = (code >> (8 * f)) & 0xFFu;
    const int j = (int)(move & 0x1Fu);
    // The tile at j moves to the blank's cell, and j becomes the blank
    // (last, so that j == blank leaves a blank).
    uint32_t tile = 0u;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) tile = k == j ? v[k] : tile;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k)
      v[k] = k == j ? 0u : (k == blank ? tile : v[k]);
    return (move & 0x80u) != 0;
  }

  // No symmetry: the wrapper refuses use_sym for this model.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}
};

// Calls fn with the instance that holds a rows x cols board of 2 to 16
// cells, the least capacity of 4, 6, 9, 12 and 16 cells at or above it;
// `none` when none does.
template <class Fn>
long long with_puzzle(int rows, int cols, long long none, Fn&& fn) {
  if (rows < 1 || cols < 1) return none;
  const int n = rows * cols;
  if (n < 2) return none;
  if (n <= 4) return fn(SlidingPuzzle<4>::make(rows, cols));
  if (n <= 6) return fn(SlidingPuzzle<6>::make(rows, cols));
  if (n <= 9) return fn(SlidingPuzzle<9>::make(rows, cols));
  if (n <= 12) return fn(SlidingPuzzle<12>::make(rows, cols));
  if (n <= 16) return fn(SlidingPuzzle<16>::make(rows, cols));
  return none;
}

}  // namespace sr
