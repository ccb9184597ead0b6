// The transition-table form of a model's step: the expand stage of the
// single-kernel wave and of the sender kernel under a matmul plan.
//
// The device-code twin of stateright_tpu_torch/matmul_wave.py
// (matmul_expand), itself the port of stateright_tpu/tpu/matmul_wave.py
// matmul_expand :480, which the Pallas bodies trace in place of the
// model's step (pallas_table.py _wave_front :353-372, taken by
// build_wave_megakernel :380 and build_sender_megakernel :451, the tables
// as pallas_call operands at :406-432 and :472-494).
//
// A plan (matmul_wave.py classify) holds, for each key group, its key
// lanes, their strides and a table of D rows, one row a joint key value,
// and for each action the (group, column, output lane) entries it writes
// from those tables, plus its constant outputs. PlanStep<M> takes M's
// place in the tile loop (wave.cuh): M's width, layout, fanout and
// representative, and in place of M's step, for slot (row, f):
//   1. the successor starts as the parent's lanes (v as staged);
//   2. action f's constant outputs are written;
//   3. for each entry of action f, kidx = sum(lane * stride) over its
//      group's key lanes, read from an untouched copy of the parent (an
//      earlier entry may have overwritten a key lane of v), and the
//      table's row kidx, column c, goes to the entry's lane;
//   4. the output lane W is the validity: the slot is enabled iff it is
//      written nonzero, and disabled when no entry writes it (the
//      reference's sv starts at zeros).
// Each (action, output) is written by exactly one entry (classify puts it
// in one key set), so the order of the entries does not matter.
//
// The reference computes step 3 as a one-hot [B, D] times the table
// [D, 2n] of the outputs' 16-bit halves, in float32. The one-hot row of
// kidx picks exactly one table row, so the product is that row: this
// gathers it, the same function, with the tables as uint32 [D, n] in
// device memory read through the read-only path (the largest table of the
// instantiated models, increment_lock at 8 threads, is 264,704 bytes as
// the reference's float halves, 132,352 as uint32: it stays in the 50 MB
// L2). A kidx past the table (a lane outside its declared domain, which
// an unpacked row never holds) reads 0, as the reference's all-zero
// one-hot row does. Exact products on the tensor cores (byte splits on
// int8, not TF32) and tables staged in shared memory are left for a later
// change; the reference's VMEM gate for the tables (pallas_table.py
// :300-323) then gets its counterpart in the tile's shared memory.
//
// Boundaries: the device models fold theirs into their steps, and the
// models that have one (ping-pong, VSR) are not matmul-regular; the plan
// form is instantiated only for models with none (2pc, increment,
// increment_lock), and wave.py refuses a plan-form launch for a model
// with a boundary.
//
// The plan travels in the kernel's parameters (Plan below, 2,696 bytes of
// the kernel's 4 KB): the entry point copies the host int32 array of
// wave.py::plan_host into it, so a CUDA graph that captures the launch
// keeps it; the tables are a device buffer the engine keeps for the
// plan's life.

#pragma once

#include <cstdint>

#include "packing.cuh"

namespace sr {

constexpr int kPlanGroups = 32;   // key groups
constexpr int kPlanKeys = 12;     // key lanes a group (4,096 = 2^12 rows)
constexpr int kPlanEntries = 192;  // outputs written, all actions
constexpr int kPlanConsts = 64;   // constant outputs' values
constexpr int kPlanActions = 64;  // the fanout
constexpr uint32_t kConstGroup = 0xFF;  // an entry's group: a constant

// One key group: its table at word `offset` of the tables buffer, `cols`
// words a row, and its key lanes with their strides.
struct PlanGroup {
  uint32_t offset;
  uint32_t rows;  // D
  uint16_t cols;
  uint8_t nkeys;
  uint8_t key[kPlanKeys];
  uint16_t stride[kPlanKeys];
};

// A plan as the kernels take it. Entry e of action f (first[f] <= e <
// first[f + 1]) is lane | group << 8 | column << 16: the output lane (W
// for the validity), the group (kConstGroup for a constant), and the
// table's column (the constant's index in cval).
struct Plan {
  int ngroups;
  uint16_t first[kPlanActions + 1];
  uint32_t entry[kPlanEntries];
  uint32_t cval[kPlanConsts];
  PlanGroup group[kPlanGroups];
};

// The value of entry `ent` for the parent row `par` (unpacked lanes).
template <int kMaxW>
__device__ __forceinline__ uint32_t plan_value(const Plan& p,
                                               const uint32_t* tables,
                                               const uint32_t (&par)[kMaxW],
                                               uint32_t ent) {
  const uint32_t g = (ent >> 8) & 0xFFu, c = ent >> 16;
  if (g == kConstGroup) return p.cval[c];
  const PlanGroup& G = p.group[g];
  uint32_t kidx = 0;
  for (int k = 0; k < G.nkeys; ++k)
    kidx += get_lane(par, G.key[k]) * (uint32_t)G.stride[k];
  if (kidx >= G.rows) return 0u;
  return __ldg(tables + G.offset + (size_t)kidx * G.cols + c);
}

// Model M with its step replaced by the plan's (see the note at the top).
template <class M>
struct PlanStep {
  static constexpr int kMaxW = M::kMaxW;
  static constexpr int kMaxWords = M::kMaxWords;
  static constexpr int kMinFanout = M::kMinFanout;

  M m;
  Plan plan;
  const uint32_t* tables;  // every group's uint32 [rows, cols], row-major

  __host__ __device__ int width() const { return m.width(); }
  __host__ __device__ int fanout() const { return m.fanout(); }

  // Action f's successor of the row in v, in place; returns whether it is
  // enabled.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    uint32_t par[kMaxW];
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) par[j] = v[j];
    const int w = m.width();
    bool enabled = false;
    for (int e = plan.first[f]; e < plan.first[f + 1]; ++e) {
      const uint32_t ent = plan.entry[e];
      const int lane = (int)(ent & 0xFFu);
      const uint32_t x = plan_value(plan, tables, par, ent);
      if (lane == w)
        enabled = x != 0u;
      else
        set_lane(v, lane, x);
    }
    return enabled;
  }

  __device__ __forceinline__ void representative(
      uint32_t (&v)[kMaxW]) const {
    m.representative(v);
  }

  // The plan from the entry point's host array int32 (wave.py::plan_host):
  // [0] groups, [1] entries, [2] constants, [3] fanout, [4] width; then
  // each group's offset, rows, cols, nkeys, kPlanKeys keys and kPlanKeys
  // strides; then first[fanout + 1], the entries and the constants'
  // values. False when it does not fit this struct or is not M's.
  bool load(const M& model, const int* host, const void* table_words) {
    m = model;
    tables = static_cast<const uint32_t*>(table_words);
    const int ng = host[0], ne = host[1], nc = host[2], F = host[3],
              w = host[4];
    if (ng < 0 || ng > kPlanGroups || ne < 0 || ne > kPlanEntries ||
        nc < 0 || nc > kPlanConsts || F != m.fanout() ||
        F > kPlanActions || w != m.width() || w > 255)
      return false;
    plan.ngroups = ng;
    const int* q = host + 5;
    for (int g = 0; g < kPlanGroups; ++g) {
      PlanGroup& G = plan.group[g];
      G = PlanGroup{};
      if (g >= ng) continue;
      G.offset = (uint32_t)q[0];
      G.rows = (uint32_t)q[1];
      G.cols = (uint16_t)q[2];
      G.nkeys = (uint8_t)q[3];
      if (q[3] < 0 || q[3] > kPlanKeys) return false;
      for (int k = 0; k < kPlanKeys; ++k) {
        G.key[k] = (uint8_t)q[4 + k];
        G.stride[k] = (uint16_t)q[4 + kPlanKeys + k];
        if (k < G.nkeys && (q[4 + k] < 0 || q[4 + k] >= w)) return false;
      }
      q += 4 + 2 * kPlanKeys;
    }
    for (int f = 0; f <= kPlanActions; ++f)
      plan.first[f] = (uint16_t)(f <= F ? q[f] : q[F]);
    q += F + 1;
    for (int e = 0; e < kPlanEntries; ++e) {
      plan.entry[e] = e < ne ? (uint32_t)q[e] : 0u;
      if (e < ne) {
        const uint32_t ent = plan.entry[e], g = (ent >> 8) & 0xFFu;
        if ((int)(ent & 0xFFu) > w ||
            (g == kConstGroup ? (int)(ent >> 16) >= nc : (int)g >= ng))
          return false;
      }
    }
    q += ne;
    for (int c = 0; c < kPlanConsts; ++c)
      plan.cval[c] = c < nc ? (uint32_t)q[c] : 0u;
    return plan.first[0] == 0 && plan.first[F] == ne;
  }
};

#ifdef __CUDACC__

// Calls fn with model m under the plan of the host array `host` and the
// device tables `tables`, or returns cudaErrorInvalidValue when the plan
// does not fit (PlanStep::load).
template <class M, class Fn>
int with_plan(const M& m, const int* host, const void* tables, Fn&& fn) {
  PlanStep<M> p;
  if (!p.load(m, host, tables)) return (int)cudaErrorInvalidValue;
  return fn(p);
}

#endif  // __CUDACC__

}  // namespace sr
