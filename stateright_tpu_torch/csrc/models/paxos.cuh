// Single-decree paxos under the register workload as device code: the
// server policy of register_workload.cuh, whose RegisterWorkload gives the
// successor of one state under one delivery and the exact representative
// of its client-symmetry class.
//
// The device-code twin of the port's models/paxos.py::PaxosDevice
// .server_deliver :326 with its symmetry hooks :263-297, the port of
// stateright_tpu/tpu/models/paxos.py :277, after the reference's
// examples/paxos.rs:96-222.
//
// A server's 8 lanes (3 servers): ballot, proposal, prepares[3], accepts
// mask, accepted pair, decided. Internal messages carry ballot[0:4] |
// proposal | last accepted in the envelope's extra bits. At 3 servers the
// client-permutation group is trivial below 4 clients; at 4 its one
// non-identity permutation swaps clients 0 and 3.

#pragma once

#include <cstdint>

#include "register_workload.cuh"

namespace sr {

template <int kC_>
struct PaxosServer : RegisterEnv<kC_> {
  using B = RegisterEnv<kC_>;
  using typename B::Env;
  using B::env_of;
  using B::kC;
  using B::kEmpty;
  using B::kGet;
  using B::kGetOk;
  using B::kPut;
  using B::kPutOk;
  using B::kValueBits;
  using B::kValueMask;
  using B::pick;
  using B::sym_val;

  static constexpr int kS = 3;  // servers (PaxosDevice's only)
  static constexpr int kServerLanes = 8;
  static constexpr int kMaxOut = 3;  // an Accepted quorum: two Decided, PutOk
  static constexpr uint32_t kMajority = kS / 2 + 1;
  static constexpr uint32_t kPropMask = kValueMask;  // prop_bits == value
  static constexpr int kLaShift = 4 + kValueBits;
  // The largest accepted-pair index: 1 + (C * S - 1) * C + (C - 1).
  static constexpr uint32_t kLaMax = 1 + (kC * kS - 1) * kC + (kC - 1);
  static constexpr int kExtraBits = kLaShift + bit_length(kLaMax);
  static_assert(B::kExtraShift + kExtraBits < 32,
                "a network lane is a sentinel lane");
  static constexpr int kServerBits = bit_length(kC * kS) + bit_length(kC) +
                                     3 * bit_length(1 + kLaMax) + kS +
                                     bit_length(kLaMax) + 1;
  // Its own message kinds.
  static constexpr uint32_t kPrepare = 4, kPrepared = 5, kAccept = 6,
                            kAccepted = 7, kDecided = 8;

  // PaxosDevice.server_deliver at server D: every branch computes, and
  // each lane selects its value, as the torch code does.
  template <int D, int W>
  static __device__ __forceinline__ bool server(uint32_t (&v)[W],
                                                const Env& m,
                                                uint32_t (&outs)[kMaxOut]) {
    constexpr int o = D * kServerLanes;
    const uint32_t b = v[o], prop = v[o + 1], accmask = v[o + 5],
                   acc = v[o + 6], dec = v[o + 7];
    const uint32_t prep[kS] = {v[o + 2], v[o + 3], v[o + 4]};
    const uint32_t m_ballot = m.extra & 15u;
    const uint32_t m_prop = (m.extra >> 4) & kPropMask;
    const uint32_t m_la = m.extra >> kLaShift;
    // Decided and Get: GetOk with the accepted value.
    const uint32_t acc_prop = acc == 0 ? 0u : (acc - 1) % kC + 1;
    const uint32_t getok = env_of(m.src, D, kGetOk, m.req, acc_prop, 0);
    const bool case_get = dec == 1;
    // Put with no proposal: a new ballot (round + 1, self).
    const uint32_t r_cur = b == 0 ? 0u : (b - 1) / kS + 1;
    const uint32_t put_ballot = r_cur * kS + D + 1;
    const uint32_t put_prop = (m.req & 3u) + 1;
    const bool case_put = m.kind == kPut && prop == 0;
    // Prepare with a higher ballot: Prepared with the last accepted.
    const uint32_t prepared_out =
        env_of(m.src, D, kPrepared, 0, 0, m_ballot | (acc << kLaShift));
    const bool case_prepare = m.kind == kPrepare && b < m_ballot;
    // Prepared at the current ballot: on a quorum, Accept.
    uint32_t prep2[kS];
#pragma unroll
    for (int a = 0; a < kS; ++a) prep2[a] = m.src == (uint32_t)a ? 1 + m_la
                                                                 : prep[a];
    const bool quorum_p = (prep2[0] != 0 ? 1u : 0u) +
                              (prep2[1] != 0 ? 1u : 0u) +
                              (prep2[2] != 0 ? 1u : 0u) ==
                          kMajority;
    const uint32_t best = max(max(prep2[0], prep2[1]), prep2[2]) - 1;
    const uint32_t best_prop = best == 0 ? prop : (best - 1) % kC + 1;
    const uint32_t accepted_new = 1 + (b - 1) * kC + (best_prop - 1);
    const bool case_prepared = m.kind == kPrepared && m_ballot == b;
    // Accept at a ballot at least the current one: Accepted.
    const uint32_t accepted_out = env_of(m.src, D, kAccepted, 0, 0, m_ballot);
    const uint32_t la_m = 1 + (m_ballot - 1) * kC + (m_prop - 1);
    const bool case_accept = m.kind == kAccept && b <= m_ballot;
    // Accepted at the current ballot: on a quorum, Decided and PutOk.
    const uint32_t accmask2 = accmask | (1u << m.src);
    const bool quorum_a = (accmask2 & 1u) + ((accmask2 >> 1) & 1u) +
                              ((accmask2 >> 2) & 1u) ==
                          kMajority;
    const uint32_t req_k = prop - 1;
    const uint32_t putok_out = env_of(kS + req_k, D, kPutOk, req_k, 0, 0);
    const bool case_accepted = m.kind == kAccepted && m_ballot == b;
    const bool case_decided = m.kind == kDecided;

    const bool live = !case_get;
    const bool g_put = live && case_put, g_prep = live && case_prepare;
    const bool g_prpd = live && case_prepared, g_acc = live && case_accept;
    const bool g_accd = live && case_accepted, g_dec = live && case_decided;
    const bool g_prpd_q = g_prpd && quorum_p;
    v[o] = g_put ? put_ballot : (g_prep || g_acc || g_dec) ? m_ballot : b;
    v[o + 1] = g_put ? put_prop : g_prpd_q ? best_prop : prop;
#pragma unroll
    for (int a = 0; a < kS; ++a)
      v[o + 2 + a] = g_put ? (D == a ? 1 + acc : 0u)
                     : g_prpd ? prep2[a]
                              : prep[a];
    v[o + 5] = g_put      ? 0u
               : g_prpd_q ? accmask | (1u << D)
               : g_accd   ? accmask2
                          : accmask;
    v[o + 6] = g_prpd_q ? accepted_new : (g_acc || g_dec) ? la_m : acc;
    v[o + 7] = (g_accd && quorum_a) || g_dec ? 1u : dec;
    const bool handled =
        case_get ? m.kind == kGet
                 : (case_put || case_prepare || case_prepared ||
                    case_accept || case_accepted || case_decided);

    uint32_t reply = case_get && m.kind == kGet ? getok : kEmpty;
    reply = g_prep ? prepared_out : reply;
    reply = g_acc ? accepted_out : reply;
    reply = g_accd && quorum_a ? putok_out : reply;
    // Two broadcast slots: the first two of the three per-peer envelopes
    // that are not empty (the self slot is), in peer order.
    uint32_t bc[kS];
#pragma unroll
    for (int p = 0; p < kS; ++p)
      bc[p] = g_put ? (p == D ? kEmpty
                              : env_of(p, D, kPrepare, 0, 0, put_ballot))
              : g_prpd ? (quorum_p && p != D
                              ? env_of(p, D, kAccept, 0, 0,
                                       b | (best_prop << 4))
                              : kEmpty)
              : g_accd ? (quorum_a && p != D
                              ? env_of(p, D, kDecided, 0, 0, b | (prop << 4))
                              : kEmpty)
                       : kEmpty;
    const bool b0e = bc[0] != kEmpty, b1e = bc[1] != kEmpty;
    outs[0] = reply;
    outs[1] = b0e ? bc[0] : b1e ? bc[1] : bc[2];
    outs[2] = b0e && b1e ? bc[1] : b0e != b1e ? bc[2] : kEmpty;
    return handled;
  }

  // -- Client symmetry: the rewrite tables of PaxosDevice
  // .sym_extra_tables and .sym_rewrite_servers, total over each field's
  // range, each index clamped as the torch gathers are.

  // An accepted-pair index: its proposal (the client) permuted.
  static __device__ __forceinline__ uint32_t sym_la(uint32_t i, uint32_t sg) {
    i = min(i, kLaMax);
    return i == 0 ? 0u : 1 + (i - 1) / kC * kC + pick(sg, (i - 1) % kC);
  }
  // prep[i] = 1 + la[i - 1]; its clamp at kLaMax + 1 is sym_la's.
  static __device__ __forceinline__ uint32_t sym_prep(uint32_t i,
                                                      uint32_t sg) {
    return i == 0 ? 0u : 1 + sym_la(i - 1, sg);
  }
  static __device__ __forceinline__ uint32_t sym_server(int lane, uint32_t x,
                                                        uint32_t sg) {
    return lane == 1                ? sym_val(x, sg)
           : lane >= 2 && lane < 5 ? sym_prep(x, sg)
           : lane == 6             ? sym_la(x, sg)
                                   : x;
  }
  static __device__ __forceinline__ uint32_t sym_extra(uint32_t kind,
                                                       uint32_t extra,
                                                       uint32_t sg) {
    const uint32_t ballot = extra & 15u;
    return kind == kPrepared
               ? ballot | (sym_la(extra >> kLaShift, sg) << kLaShift)
           : kind == kAccept || kind == kDecided
               ? ballot | (sym_val((extra >> 4) & kPropMask, sg) << 4)
               : extra;
  }
  // The internal kinds leave req unused.
  static __device__ __forceinline__ uint32_t sym_internal_req(uint32_t,
                                                              uint32_t req,
                                                              uint32_t) {
    return req;
  }
};

template <int kC>
using Paxos = RegisterWorkload<PaxosServer<kC>>;

}  // namespace sr
