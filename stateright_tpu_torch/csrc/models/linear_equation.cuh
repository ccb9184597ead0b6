// LinearEquation as device code: the successor of one state under one
// action.
//
// The device-code twin of stateright_tpu_torch/test_util.py
// (LinearEquationDevice.step), itself the port of
// stateright_tpu/test_util.py's _LinearEquationDevice :177, after the
// reference's src/test_util.rs:141-188.
//
// Lanes (w = 2, 32 bits each, stored unpacked): x and y. Action 0
// increments x, action 1 y, each wrapping at 256 (a uint32 sum taken mod
// 256, as the torch and JAX steps do); both are always enabled. No
// boundary, no error lane, no symmetry.

#pragma once

#include <cstdint>

namespace sr {

struct LinearEquation {
  static constexpr int kMaxW = 2;
  static constexpr int kMaxWords = 2;
  static constexpr int kMinFanout = 2;

  __host__ __device__ int width() const { return 2; }
  __host__ __device__ int fanout() const { return 2; }

  // Applies action f to the state in v, in place; always enabled.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    if (f == 0)
      v[0] = (v[0] + 1u) % 256u;
    else
      v[1] = (v[1] + 1u) % 256u;
    return true;
  }

  // No symmetry: the wrapper refuses use_sym for this model.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}
};

}  // namespace sr
