// Viewstamped replication as device code: the successor of one state under
// one action of the actor layer (a delivery, a drop or a replica's
// timeout), its boundary folded into the enabled bit.
//
// The device-code twin of stateright_tpu_torch/models/vsr.py
// (VsrDevice.deliver, .timeout and .boundary on ActorDeviceModel.step),
// itself the port of stateright_tpu/tpu/models/vsr.py deliver :161-320,
// timeout :322-371 and boundary :373, after the host handlers of
// stateright_tpu/actor/viewstamped.py.
//
// Lanes (w = 8N + 1 + e + 1): replica i's eight ReplicaState fields at 8i
// (view, status, op_val, committed, oks, svc, dvc, dvc_best); the timer
// bitmask at 8N (kTimerOff); the network of e slots from 8N + 1
// (actor_net.cuh) and the overflow flag. Envelope: ((((view << 4) | val)
// << 3 | kind) << 2 | src) << 2 | dst, kinds Prepare 0, PrepareOk 1,
// Commit 2, StartViewChange 3, DoViewChange 4, StartView 5.
//
// A delivery reads its receiver's row at min(dst, N - 1) and writes it back
// only at dst < N, as JAX's clamped gather and dropped scatter do on rows
// no run reaches. Every field is a where-cascade as in the torch code; the
// broadcasting branches (Commit on quorum, StartViewChange gossip, StartView
// on completion) exclude each other by kind and fill sends 0 to N - 2, the
// unicast (PrepareOk, DoViewChange) send N - 1. A timeout is always handled.
// The network's form (lossy, duplicating) and max_view are runtime; N
// (2 to 4) and kMaxE are the instance's. No symmetry; every lane a whole
// word.

#pragma once

#include <cstdint>

#include "actor_net.cuh"

namespace sr {

template <int N, int kMaxE_>
struct Vsr {
  static_assert(N >= 1 && N <= 4, "the envelope holds 1 to 4 replicas");
  static constexpr int kMaxE = kMaxE_;
  static constexpr int kTimerOff = 8 * N;
  static constexpr int kNetOff = 8 * N + 1;
  static constexpr int kMaxW = kNetOff + kMaxE + 1;
  // No lane_bits(): each lane is a whole word, and a row is copied, not
  // packed (wave.cuh's WholeWords).
  static constexpr int kMaxWords = kMaxW;
  static constexpr bool kWholeWords = true;
  static constexpr int kMaxOut = N;
  static constexpr int kTimers = N;
  static constexpr int kMinFanout = kMaxE;
  static constexpr uint32_t kMaj = N / 2 + 1;
  static constexpr uint32_t kPrepare = 0, kPrepareOk = 1, kCommit = 2,
                            kStartVc = 3, kDoVc = 4, kStartView = 5;

  int e;  // net_slots, 1 <= e <= kMaxE
  bool lossy, duplicating;
  uint32_t max_view;

  __host__ __device__ int width() const { return kNetOff + e + 1; }
  __host__ __device__ int fanout() const { return (lossy ? 2 * e : e) + N; }

  // Applies action f to the state in v, in place; returns whether it is
  // enabled and its successor lies inside the boundary (every view at most
  // max_view).
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    bool inside = actor_step(*this, v, f);
#pragma unroll
    for (int i = 0; i < N; ++i) inside = inside && v[8 * i] <= max_view;
    return inside;
  }

  static __device__ __forceinline__ uint32_t popcount(uint32_t mask) {
    uint32_t total = 0;
#pragma unroll
    for (int b = 0; b < N; ++b) total += (mask >> b) & 1u;
    return total;
  }

  static __device__ __forceinline__ uint32_t enc(uint32_t view, uint32_t val,
                                                 uint32_t kind, uint32_t src,
                                                 uint32_t dst) {
    return (((((view << 4) | val) << 3 | kind) << 2 | src) << 2) | dst;
  }

  // Replica r's eight lanes (r < N).
  static __device__ __forceinline__ void get_row(const uint32_t (&v)[kMaxW],
                                                 uint32_t r,
                                                 uint32_t (&row)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((uint32_t)i == r) x = v[8 * i + k];
      row[k] = x;
    }
  }

  // Sets replica r's lanes to row; nothing where r >= N.
  static __device__ __forceinline__ void set_row(uint32_t (&v)[kMaxW],
                                                 uint32_t r,
                                                 const uint32_t (&row)[8]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((uint32_t)i == r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[8 * i + k] = row[k];
      }
  }

  // VsrDevice.deliver: the envelope's effect at its receiver, and its sends.
  __device__ __forceinline__ bool on_deliver(uint32_t (&v)[kMaxW],
                                             uint32_t env,
                                             uint32_t (&outs)[kMaxOut]) const {
    const uint32_t dst = env & 3u, src = (env >> 2) & 3u;
    const uint32_t kind = (env >> 4) & 7u, val = (env >> 7) & 15u;
    const uint32_t view = (env >> 11) & 15u;
    uint32_t row[8];
    get_row(v, dst < (uint32_t)N ? dst : (uint32_t)(N - 1), row);
    const uint32_t s_view = row[0], s_status = row[1], s_op = row[2],
                   s_com = row[3], s_oks = row[4], s_svc = row[5],
                   s_dvc = row[6], s_best = row[7];
    const uint32_t i_bit = 1u << dst, j_bit = 1u << src;
    const bool is_primary = view % N == dst;

    // Prepare (view, x): accept and ack, or catch up.
    const bool p_catch = kind == kPrepare && view > s_view;
    const bool p_same = kind == kPrepare && view == s_view && s_status == 0 &&
                        !is_primary && s_op == 0;
    const bool prep_handled = p_catch || p_same;
    // PrepareOk (view): quorum counting at the primary.
    const bool ok_valid = kind == kPrepareOk && view == s_view &&
                          s_status == 0 && s_view % N == dst && s_op != 0 &&
                          s_com == 0;
    const uint32_t oks2 = s_oks | j_bit | i_bit;
    const bool ok_changed = ok_valid && oks2 != s_oks;
    const bool ok_quorum = ok_changed && popcount(oks2) >= kMaj;
    // Commit (view, x): adopt the committed fact.
    const bool c_fresh = kind == kCommit && s_com == 0;
    const bool c_newer = c_fresh && view > s_view;
    // StartViewChange (view): gossip and quorum.
    const bool svc_enter = kind == kStartVc && view > s_view;
    const bool svc_same = kind == kStartVc && view == s_view && s_status == 1;
    const uint32_t svc_mask_enter = i_bit | j_bit;
    const uint32_t svc_mask_same = s_svc | j_bit;
    const bool svc_changed = svc_same && svc_mask_same != s_svc;
    const bool svc_handled = svc_enter || svc_changed;
    const bool svc_send_dvc =
        (svc_enter && popcount(svc_mask_enter) >= kMaj) ||
        (svc_changed && popcount(svc_mask_same) >= kMaj &&
         popcount(s_svc) < kMaj);
    // DoViewChange (view, o): the new primary collects.
    const bool dvc_newer = kind == kDoVc && is_primary && view > s_view;
    const bool dvc_same =
        kind == kDoVc && is_primary && view == s_view && s_status == 1;
    const uint32_t dvc_mask_newer = i_bit | j_bit;
    const uint32_t best_newer = max(s_op, val);
    const uint32_t dvc_mask_same = s_dvc | j_bit | i_bit;
    const uint32_t best_same = max(max(s_best, s_op), val);
    const bool dvc_changed =
        dvc_same && (dvc_mask_same != s_dvc || best_same != s_best);
    const bool dvc_handled = dvc_newer || dvc_changed;
    const bool dvc_complete =
        (dvc_newer && popcount(dvc_mask_newer) >= kMaj) ||
        (dvc_changed && popcount(dvc_mask_same) >= kMaj &&
         popcount(s_dvc) < kMaj);
    const uint32_t dvc_mask = dvc_newer ? dvc_mask_newer : dvc_mask_same;
    const uint32_t dvc_best = dvc_newer ? best_newer : best_same;
    // StartView (view, o): adopt the announced op.
    const bool sv_adopt =
        kind == kStartView &&
        (view > s_view || (view == s_view && s_status == 1));
    const bool sv_ack = sv_adopt && val != 0 && s_com == 0;

    const bool handled = prep_handled || ok_changed || c_fresh ||
                         svc_handled || dvc_handled || sv_adopt;

    const bool reset = p_catch || c_newer || svc_enter || dvc_newer ||
                       sv_adopt;
    const bool cleared = p_catch || c_newer || svc_enter || sv_adopt;
    uint32_t n[8];
    n[0] = reset ? view : s_view;
    uint32_t st = (p_catch || c_newer || sv_adopt) ? 0u : s_status;
    st = (svc_enter || dvc_newer) ? 1u : st;
    n[1] = dvc_complete ? 0u : st;
    uint32_t op = (prep_handled || c_newer) ? val : s_op;
    op = (c_fresh && !c_newer) ? (s_op == 0 ? val : s_op) : op;
    op = sv_adopt ? val : op;
    n[2] = dvc_complete ? dvc_best : op;
    const uint32_t com = c_fresh ? val : s_com;
    n[3] = ok_quorum ? s_op : com;
    uint32_t oks = reset ? 0u : s_oks;
    oks = ok_changed ? oks2 : oks;
    n[4] = dvc_complete ? (dvc_best != 0 ? i_bit : 0u) : oks;
    uint32_t svc = (p_catch || c_newer || dvc_newer || sv_adopt) ? 0u : s_svc;
    svc = svc_enter ? svc_mask_enter : svc;
    svc = svc_changed ? svc_mask_same : svc;
    n[5] = dvc_complete ? 0u : svc;
    const uint32_t dvc = dvc_handled ? dvc_mask : (cleared ? 0u : s_dvc);
    n[6] = dvc_complete ? 0u : dvc;
    const uint32_t best = dvc_handled ? dvc_best : (cleared ? 0u : s_best);
    n[7] = dvc_complete ? 0u : best;
    if (!handled) {
#pragma unroll
      for (int k = 0; k < 8; ++k) n[k] = row[k];
    }
    set_row(v, dst, n);

#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      const uint32_t other = (uint32_t)k < dst ? (uint32_t)k : k + 1u;
      uint32_t x = kEmptyEnv;
      if (ok_quorum) x = enc(s_view, s_op, kCommit, dst, other);
      if (svc_enter) x = enc(view, 0, kStartVc, dst, other);
      if (dvc_complete) x = enc(view, dvc_best, kStartView, dst, other);
      outs[k] = x;
    }
    uint32_t uni = kEmptyEnv;
    if (prep_handled || sv_ack) uni = enc(view, 0, kPrepareOk, dst, src);
    if (svc_send_dvc) uni = enc(view, s_op, kDoVc, dst, view % N);
    outs[N - 1] = uni;
    return handled;
  }

  // VsrDevice.timeout of replica a: the primary of a normal view with
  // nothing accepted proposes, a backup in a normal view suspects the
  // primary; else nothing changes. Always handled.
  __device__ __forceinline__ bool on_timeout(uint32_t (&v)[kMaxW], int a,
                                             uint32_t (&outs)[kMaxOut]) const {
    uint32_t row[8];
    get_row(v, (uint32_t)a, row);
    const uint32_t s_view = row[0], s_status = row[1], s_op = row[2];
    const uint32_t i_bit = 1u << a;
    const bool is_primary = s_view % N == (uint32_t)a;
    const bool propose = s_status == 0 && is_primary && s_op == 0;
    const bool suspect = s_status == 0 && !is_primary;
    const uint32_t nv = s_view + 1u;
    uint32_t n[8];
    n[0] = suspect ? nv : s_view;
    n[1] = suspect ? 1u : s_status;
    n[2] = propose ? nv : s_op;
    n[3] = row[3];
    n[4] = propose ? i_bit : (suspect ? 0u : row[4]);
    n[5] = suspect ? i_bit : row[5];
    n[6] = suspect ? 0u : row[6];
    n[7] = suspect ? 0u : row[7];
    set_row(v, (uint32_t)a, n);
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      const uint32_t other = k < a ? (uint32_t)k : k + 1u;
      uint32_t x = kEmptyEnv;
      if (propose) x = enc(s_view, nv, kPrepare, a, other);
      if (suspect) x = enc(nv, 0, kStartVc, a, other);
      outs[k] = x;
    }
    outs[N - 1] = kEmptyEnv;
    return true;
  }

  // No symmetry: the row is its own representative.
  __device__ __forceinline__ void representative(uint32_t (&)[kMaxW]) const {}
};

}  // namespace sr
