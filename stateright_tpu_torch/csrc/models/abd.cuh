// The ABD quorum register as device code: the server policy of
// register_workload.cuh, whose RegisterWorkload gives the successor of one
// state under one delivery.
//
// The device-code twin of the port's models/abd.py::AbdDevice
// .server_deliver, the port of stateright_tpu/tpu/models/abd.py :167-304,
// after the reference's examples/linearizable-register.rs:68-186.
//
// A server's 7 + kS lanes: seq (clock * S + id), val, ph_kind (0 none, 1
// query, 2 record), ph_req, ph_write (0 = a read, else the value), ph_read
// (0 = a write, else 1 + the value), ph_acks (a server bitmask), then one
// response a server (0 = none, else 1 + seq * (C + 1) + value). AckQuery
// and Record carry a sequencer in the envelope's extra bits. The
// client-permutation group is trivial on every configuration that has a
// device form (kC <= kS), so the representative is the row itself and the
// policy has no symmetry hooks.

#pragma once

#include <cstdint>

#include "register_workload.cuh"

namespace sr {

template <int kC_, int kS_>
struct AbdServer : RegisterEnv<kC_> {
  using B = RegisterEnv<kC_>;
  using typename B::Env;
  using B::env_of;
  using B::kC;
  using B::kEmpty;
  using B::kGet;
  using B::kGetOk;
  using B::kPut;
  using B::kPutOk;

  static constexpr int kS = kS_;
  static_assert(kS >= 1 && kS + kC <= 8, "the actor field is 3 bits");
  static_assert(kC <= kS, "request ids collide: no device form");
  static constexpr int kServerLanes = 7 + kS;
  static constexpr int kMaxOut = kS > 2 ? kS - 1 : 1;
  static constexpr uint32_t kMajority = kS / 2 + 1;
  static constexpr int kSeqMax = kC * kS + kS - 1;
  static constexpr int kExtraBits = max_int(1, bit_length(kSeqMax));
  static constexpr int kServerBits =
      max_int(1, bit_length(kSeqMax)) + 2 * bit_length(kC) + 2 + 3 +
      bit_length(kC + 1) + kS +
      kS * bit_length(1 + kSeqMax * (kC + 1) + kC);
  // Its own message kinds.
  static constexpr uint32_t kQuery = 4, kAckQuery = 5, kRecord = 6,
                            kAckRecord = 7;

  // AbdActor.on_msg at server D: every branch computes, and each lane
  // selects its value, as the torch code does; the kinds exclude each
  // other.
  template <int D, int W>
  static __device__ __forceinline__ bool server(uint32_t (&v)[W],
                                                const Env& m,
                                                uint32_t (&outs)[kMaxOut]) {
    constexpr int o = D * kServerLanes;
    const uint32_t seq = v[o], val = v[o + 1], ph_kind = v[o + 2],
                   ph_req = v[o + 3], ph_write = v[o + 4],
                   ph_read = v[o + 5], ph_acks = v[o + 6];
    // Put or Get with no phase in flight: the query phase, with the
    // server's own (seq, val) as its first response.
    const bool start = (m.kind == kPut || m.kind == kGet) && ph_kind == 0;
    const uint32_t self_resp = 1 + seq * (kC + 1) + val;
    // Query: reply with (seq, val).
    const bool query = m.kind == kQuery;
    // AckQuery in our query phase of the same request.
    const bool ackq = m.kind == kAckQuery && ph_kind == 1 && ph_req == m.req;
    const uint32_t m_resp = 1 + m.extra * (kC + 1) + m.value;
    uint32_t resp2[kS];
    uint32_t count = 0, most = 0;
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      resp2[j] = m.src == (uint32_t)j ? m_resp : v[o + 7 + j];
      count += resp2[j] != 0 ? 1u : 0u;
      most = max(most, resp2[j]);
    }
    const bool quorum_q = count == kMajority;
    const uint32_t best = most - 1;  // distinct seqs: the max code's seq
    const uint32_t best_seq = best / (kC + 1), best_val = best % (kC + 1);
    const bool is_write = ph_write != 0;
    const uint32_t new_seq = is_write ? (best_seq / kS + 1) * kS + D
                                      : best_seq;
    const uint32_t new_val = is_write ? ph_write : best_val;
    const bool adopt = quorum_q && new_seq > seq;  // the self-sent Record
    // Record: ack, and adopt the pair if newer.
    const bool record = m.kind == kRecord;
    const bool rec_adopt = m.extra > seq;
    // AckRecord in our record phase of the same request, from a new acker.
    const bool ackr = m.kind == kAckRecord && ph_kind == 2 &&
                      ph_req == m.req && ((ph_acks >> m.src) & 1u) == 0;
    const uint32_t acks2 = ph_acks | (1u << m.src);
    uint32_t acked = 0;
#pragma unroll
    for (int j = 0; j < kS; ++j) acked += (acks2 >> j) & 1u;
    const bool quorum_r = acked == kMajority;

    if (start) {
      v[o + 2] = 1;
      v[o + 3] = m.req;
      v[o + 4] = m.kind == kPut ? m.value : 0u;
      v[o + 5] = 0;
      v[o + 6] = 0;
#pragma unroll
      for (int j = 0; j < kS; ++j) v[o + 7 + j] = j == D ? self_resp : 0u;
    }
    if (ackq) {
      v[o] = adopt ? new_seq : seq;
      v[o + 1] = adopt ? new_val : val;
      v[o + 2] = quorum_q ? 2u : 1u;
      v[o + 4] = quorum_q ? 0u : ph_write;
      v[o + 5] = quorum_q && !is_write ? 1 + best_val : 0u;
      v[o + 6] = quorum_q ? 1u << D : 0u;
#pragma unroll
      for (int j = 0; j < kS; ++j) v[o + 7 + j] = quorum_q ? 0u : resp2[j];
    }
    if (record) {
      v[o] = rec_adopt ? m.extra : seq;
      v[o + 1] = rec_adopt ? m.value : val;
    }
    if (ackr) {
      v[o + 2] = quorum_r ? 0u : 2u;
      v[o + 3] = quorum_r ? 0u : ph_req;
      v[o + 5] = quorum_r ? 0u : ph_read;
      v[o + 6] = quorum_r ? 0u : acks2;
    }

    // Broadcasts to the peers (the self slot is empty): Query on the start,
    // Record on the query quorum; the first kMaxOut in peer order
    // (compact_envs).
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) outs[k] = kEmpty;
    unsigned rank = 0;
#pragma unroll
    for (int p = 0; p < kS; ++p) {
      const uint32_t x =
          p == D ? kEmpty
          : start ? env_of(p, D, kQuery, m.req, 0, 0)
          : ackq && quorum_q ? env_of(p, D, kRecord, ph_req, new_val, new_seq)
                             : kEmpty;
      if (x != kEmpty) {
#pragma unroll
        for (int k = 0; k < kMaxOut; ++k)
          if ((unsigned)k == rank) outs[k] = x;
        ++rank;
      }
    }
    // The reply slot (never live together with a broadcast).
    const uint32_t requester = kS + (ph_req & 3u);
    const uint32_t reply =
        query ? env_of(m.src, D, kAckQuery, m.req, val, seq)
        : record ? env_of(m.src, D, kAckRecord, m.req, 0, 0)
        : ackr && quorum_r
            ? (ph_read != 0 ? env_of(requester, D, kGetOk, ph_req,
                                     ph_read - 1, 0)
                            : env_of(requester, D, kPutOk, ph_req, 0, 0))
            : kEmpty;
    if (reply != kEmpty) outs[0] = reply;
    return start || query || ackq || record || ackr;
  }
};

template <int kC, int kS>
using Abd = RegisterWorkload<AbdServer<kC, kS>>;

}  // namespace sr
