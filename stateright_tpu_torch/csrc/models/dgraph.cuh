// DGraph as device code: the successor of one node under one action.
//
// The device-code twin of stateright_tpu_torch/test_util.py
// (DGraphDevice.step), itself the port of stateright_tpu/test_util.py's
// _DGraphDevice :101, after the reference's src/test_util.rs:49-117.
//
// One lane (32 bits, stored unpacked): the node id. Action f of node v is
// its f-th successor in ascending order, enabled when f < degree[v]; a
// disabled slot holds node 0, and a node id past the table reads its last
// node (JAX's clamped gather), as the torch step does. No boundary, no
// error lane, no symmetry.
//
// The graph is per instance, so it travels in the kernel's parameters:
// the entry point (wave_dgraph.cu) copies the host table into this struct,
// which the launch passes by value. A CUDA graph that captures the launch
// keeps the table with it, and nothing on the device has to outlive the
// checker. At most kMaxNodes nodes and successors a node (1,056 bytes of
// the kernel's 4 KB of parameters); DGraphDevice.cuda_model() refuses a
// larger graph.

#pragma once

#include <cstdint>

namespace sr {

struct DGraph {
  static constexpr int kMaxW = 1;
  static constexpr int kMaxWords = 1;
  static constexpr int kMinFanout = 1;
  static constexpr int kMaxNodes = 32;

  int n;  // nodes
  int F;  // the most successors of a node
  uint8_t degree[kMaxNodes];
  uint8_t succ[kMaxNodes][kMaxNodes];

  __host__ __device__ int width() const { return 1; }
  __host__ __device__ int fanout() const { return F; }

  // Applies action f to the node in v, in place, and returns whether it is
  // enabled.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    const uint32_t node = min(v[0], (uint32_t)(n - 1));
    v[0] = succ[node][f];
    return f < degree[node];
  }

  // No symmetry: the wrapper refuses use_sym for this model.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}

  // The graph from the entry point's host table int32[2 + n + n * F]: n,
  // F, each node's degree, the successors row by row. False when it does
  // not fit.
  bool load(const int* table) {
    n = table[0];
    F = table[1];
    if (n < 1 || n > kMaxNodes || F < 1 || F > kMaxNodes) return false;
    for (int v = 0; v < kMaxNodes; ++v) {
      degree[v] = v < n ? (uint8_t)table[2 + v] : 0;
      for (int f = 0; f < kMaxNodes; ++f)
        succ[v][f] = v < n && f < F ? (uint8_t)table[2 + n + v * F + f] : 0;
    }
    return true;
  }
};

}  // namespace sr
