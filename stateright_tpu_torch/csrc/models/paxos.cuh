// Single-decree paxos under the register workload as device code: the
// successor of one state under one delivery, and the exact representative
// of its client-symmetry class.
//
// The device-code twin of the port's batch-first torch functions:
// actor_device.py::ActorDeviceModel.step :101 (net_remove_at :50, the
// model's deliver, net_insert :59), register_workload.py
// ::RegisterWorkloadDevice.deliver :366, ._client_deliver :385,
// .build_env :273, ._sym_rewrite :517 and .representative :553, and
// models/paxos.py::PaxosDevice.server_deliver :326 with its symmetry
// hooks :263-297. Those are the port of stateright_tpu/tpu/actor_device.py
// :127 (_net_effect) and :161, tpu/register_workload.py :511, :537, :701
// and :749, and tpu/models/paxos.py :277, after the reference's
// examples/paxos.rs:96-222.
//
// Lanes, 3 servers and kC clients: [0, 24) each server's ballot, proposal,
// prepares[3], accepts mask, accepted pair, decided; [24, 24 + kC) each
// client's phase; then each client's history triple (status, read's return,
// happened-before edges); then the network, e sorted envelopes padded with
// kEmpty (all ones, a sentinel lane of the packed row); then the overflow
// flag, the model's error lane. Envelope bits: dst 0:3, src 3:6, kind
// 6:10, req 10:13, value 13:13+kValueBits, extra above.
//
// Every slot's successor is computed, enabled or not, on any row: the
// arithmetic is the torch step's uint32 arithmetic, which that code keeps
// with int64 lanes and masks; here uint32_t wraps on its own. Divisions and
// remainders run only where the torch code selects them (their operand is
// then positive), and each table gather clamps as the torch one does.
//
// Runtime indices: the server count and kC are compile-time constants, so
// a switch on the envelope's destination leaves every server lane at a
// constant index; the network's removal and inserts are compare-and-select
// loops over kMaxE slots, and the runtime net_slots e (1 <= e <= kMaxE,
// the model's default) guards each slot as TwoPhase's n does.

#pragma once

#include <cstdint>

#include "../packing.cuh"

namespace sr {

constexpr int bit_length(unsigned x) { return x ? 1 + bit_length(x >> 1) : 0; }

template <int kC>
struct Paxos {
  static_assert(kC >= 1 && kC <= 4, "the encoding holds 1 to 4 clients");
  static constexpr int kS = 3;             // servers (PaxosDevice's only)
  static constexpr int kServerLanes = 8;
  static constexpr uint32_t kMajority = kS / 2 + 1;
  static constexpr int kPhaseOff = kS * kServerLanes;
  static constexpr int kHistOff = kPhaseOff + kC;
  static constexpr int kNetOff = kHistOff + 3 * kC;
  // The default net_slots: max(5C + 3, C * (max_out + 2)).
  static constexpr int kMaxE = 5 * kC + 3;
  static constexpr int kMaxW = kNetOff + kMaxE + 1;
  static constexpr int kMinFanout = kMaxE;
  static constexpr uint32_t kEmpty = 0xFFFFFFFFu;

  static constexpr int kValueBits = kC <= 3 ? 2 : 3;
  static constexpr uint32_t kValueMask = (1u << kValueBits) - 1;
  static constexpr int kExtraShift = 13 + kValueBits;
  static constexpr uint32_t kPropMask = kValueMask;  // prop_bits == value
  static constexpr int kLaShift = 4 + kValueBits;
  // The largest accepted-pair index: 1 + (C * S - 1) * C + (C - 1).
  static constexpr uint32_t kLaMax = 1 + (kC * kS - 1) * kC + (kC - 1);

  // Bits of a packed row at kMaxE (lane_bits()), hence kMaxWords.
  static constexpr int kEnvBits =
      kExtraShift + kLaShift + bit_length(kLaMax);
  static_assert(kEnvBits < 32, "a network lane is a sentinel lane");
  static constexpr int kRowBits =
      kS * (bit_length(kC * kS) + bit_length(kC) +
            3 * bit_length(1 + kLaMax) + kS + bit_length(kLaMax) + 1) +
      2 * kC + kC * (3 + kValueBits + 2 * kC) + kMaxE * (kEnvBits + 1) + 1;
  static constexpr int kMaxWords = (kRowBits + 31) / 32;

  // Message kinds: the register interface's four, then paxos's own.
  static constexpr uint32_t kPut = 0, kGet = 1, kPutOk = 2, kGetOk = 3,
                            kPrepare = 4, kPrepared = 5, kAccept = 6,
                            kAccepted = 7, kDecided = 8;

  int e;  // net_slots, 1 <= e <= kMaxE

  __host__ __device__ int width() const { return kNetOff + e + 1; }
  __host__ __device__ int fanout() const { return e; }

  struct Env {
    uint32_t dst, src, kind, req, value, extra;
  };

  static __device__ __forceinline__ Env fields(uint32_t x) {
    return Env{x & 7u,         (x >> 3) & 7u,
               (x >> 6) & 15u, (x >> 10) & 7u,
               (x >> 13) & kValueMask, x >> kExtraShift};
  }

  // build_env: the envelope of these fields, wrapped to 32 bits.
  static __device__ __forceinline__ uint32_t env_of(uint32_t dst,
                                                    uint32_t src,
                                                    uint32_t kind,
                                                    uint32_t req,
                                                    uint32_t value,
                                                    uint32_t extra) {
    return dst | (src << 3) | (kind << 6) | (req << 10) | (value << 13) |
           (extra << kExtraShift);
  }

  // Delivers the f-th envelope of the row in v, in place: the delivery's
  // effect, the envelope removed, up to three sends inserted at their rank
  // (a send into a full list drops the largest and sets the overflow
  // lane). Returns whether the action is enabled: a real envelope that its
  // destination handles.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    uint32_t net[kMaxE + 1];
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) net[i] = i < e ? v[kNetOff + i] : kEmpty;
    net[kMaxE] = kEmpty;
    uint32_t env = kEmpty, err = 0;
#pragma unroll
    for (int i = 0; i < kMaxE; ++i)
      if (i == f) env = net[i];
#pragma unroll
    for (int i = 0; i <= kMaxE; ++i)
      if (i == e) err = v[kNetOff + i];
    const Env m = fields(env);
    uint32_t outs[3] = {kEmpty, kEmpty, kEmpty};
    bool handled;
    switch (m.dst) {
      case 0:
        handled = server<0>(v, m, outs);
        break;
      case 1:
        handled = server<1>(v, m, outs);
        break;
      case 2:
        handled = server<2>(v, m, outs);
        break;
      default:
        handled = client(v, m, outs);
    }
    // net_remove_at: the tail past slot f shifts left.
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) net[i] = i < f ? net[i] : net[i + 1];
    // net_insert, a send at a time.
    bool overflow = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t x = outs[j];
      bool dup = false;
      unsigned pos = 0;
      uint32_t last = kEmpty;
#pragma unroll
      for (int i = 0; i < kMaxE; ++i) {
        dup = dup || net[i] == x;
        pos += net[i] < x ? 1u : 0u;
        if (i == e - 1) last = net[i];
      }
      const bool skip = x == kEmpty || dup;
      overflow = overflow || (!skip && last != kEmpty);
      if (!skip) {
#pragma unroll
        for (int i = kMaxE - 1; i > 0; --i)
          net[i] = (unsigned)i < pos ? net[i]
                   : (unsigned)i == pos ? x
                                        : net[i - 1];
        net[0] = pos == 0 ? x : net[0];
        // The slot past the list's end took the dropped envelope.
#pragma unroll
        for (int i = 0; i < kMaxE; ++i)
          if (i >= e) net[i] = kEmpty;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxE; ++i)
      if (i < e) v[kNetOff + i] = net[i];
#pragma unroll
    for (int i = 0; i <= kMaxE; ++i)
      if (i == e) v[kNetOff + i] = overflow ? 1u : err;
    return env != kEmpty && handled;
  }

  // PaxosDevice.server_deliver at server D: every branch computes, and
  // each lane selects its value, as the torch code does.
  template <int D>
  __device__ __forceinline__ bool server(uint32_t (&v)[kMaxW], const Env& m,
                                         uint32_t (&outs)[3]) const {
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

  // RegisterWorkloadDevice._client_deliver: the Put-then-Get client k =
  // dst - S and its history triple.
  __device__ __forceinline__ bool client(uint32_t (&v)[kMaxW], const Env& m,
                                         uint32_t (&outs)[3]) const {
    const uint32_t k = m.dst - kS;  // wraps for a server: never selected
    const uint32_t kc = min(k, (uint32_t)(kC - 1));
    uint32_t phase = 0;
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if ((uint32_t)j == kc) phase = v[kPhaseOff + j];
    const bool req_matches = (m.req & 3u) == k && (m.req >> 2) + 1 == phase;
    const bool putok = m.kind == kPutOk && phase == 1 && req_matches;
    const bool getok = m.kind == kGetOk && phase == 2 && req_matches;
    const uint32_t new_phase = putok ? 2u : getok ? 3u : phase;
    // Happened-before edges at the read's invocation: each peer's completed
    // ops (0, 1 or 2), 2 bits a peer.
    uint32_t hb = 0;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const uint32_t st = v[kHistOff + 3 * j];
      const uint32_t comp = st >= 4 ? 2u : st >= 2 ? 1u : 0u;
      hb |= ((uint32_t)j == k ? 0u : comp) << (2 * j);
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if ((uint32_t)j == k) {
        v[kPhaseOff + j] = new_phase;
        if (putok) {
          v[kHistOff + 3 * j] = 3;
          v[kHistOff + 3 * j + 2] = hb;
        }
        if (getok) {
          v[kHistOff + 3 * j] = 4;
          v[kHistOff + 3 * j + 1] = m.value;
        }
      }
    }
    // After PutOk the client Gets from server (actor + 1) % S.
    outs[0] = putok ? env_of((m.dst + 1) % kS, m.dst, kGet, 4u | min(k, 3u),
                             0, 0)
                    : kEmpty;
    return putok || getok;
  }

  // -- Client symmetry (4 clients; the group is trivial below) -------------
  //
  // At 3 servers only clients of one residue class mod 3 are exchangeable,
  // so the group's one non-identity permutation swaps clients 0 and 3 (an
  // involution: sigma is its own inverse). The functions below are the
  // rewrite tables of _sym_tables and PaxosDevice.sym_extra_tables, total
  // over each field's range, each index clamped as the torch gathers are.

  static __device__ __forceinline__ uint32_t sigma(uint32_t q) {
    return q == 0 ? 3u : q == 3 ? 0u : q;
  }
  static __device__ __forceinline__ uint32_t sym_val(uint32_t x) {
    return x == 1 ? 4u : x == 4 ? 1u : x;  // 1 + k -> 1 + sigma[k]
  }
  static __device__ __forceinline__ uint32_t sym_req(uint32_t r) {
    return (r & 4u) | sigma(r & 3u);
  }
  static __device__ __forceinline__ uint32_t sym_actor(uint32_t a) {
    return a == 3 ? 6u : a == 6 ? 3u : a;  // S + k -> S + sigma[k]
  }
  static __device__ __forceinline__ uint32_t sym_la(uint32_t i) {
    i = min(i, kLaMax);
    return i == 0 ? 0u : 1 + ((i - 1) & ~3u) + sigma((i - 1) & 3u);
  }
  // prep[i] = 1 + la[i - 1]; its clamp at kLaMax + 1 is sym_la's.
  static __device__ __forceinline__ uint32_t sym_prep(uint32_t i) {
    return i == 0 ? 0u : 1 + sym_la(i - 1);
  }

  // One envelope under the permutation (not the empty one).
  static __device__ __forceinline__ uint32_t sym_env(uint32_t x) {
    const Env m = fields(x);
    const uint32_t ballot = m.extra & 15u;
    const uint32_t extra =
        m.kind == kPrepared
            ? ballot | (sym_la(m.extra >> kLaShift) << kLaShift)
        : m.kind == kAccept || m.kind == kDecided
            ? ballot |
                  (sym_val(min((m.extra >> 4) & kPropMask, kValueMask)) << 4)
            : m.extra;
    return env_of(sym_actor(m.dst), sym_actor(m.src), m.kind,
                  m.kind < 4 ? sym_req(m.req) : m.req, sym_val(m.value),
                  extra);
  }

  // The least encoded row of v's class, in place.
  __device__ __forceinline__ void representative(uint32_t (&v)[kMaxW]) const {
    if constexpr (kC == 4) {
      uint32_t c[kMaxW];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int o = s * kServerLanes;
        c[o] = v[o];
        c[o + 1] = sym_val(min(v[o + 1], kValueMask));
#pragma unroll
        for (int a = 2; a < 5; ++a) c[o + a] = sym_prep(v[o + a]);
        c[o + 5] = v[o + 5];
        c[o + 6] = sym_la(v[o + 6]);
        c[o + 7] = v[o + 7];
      }
      // New client j is old client sigma[j]; its edges re-indexed too.
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int i = (int)sigma(j);
        c[kPhaseOff + j] = v[kPhaseOff + i];
        c[kHistOff + 3 * j] = v[kHistOff + 3 * i];
        c[kHistOff + 3 * j + 1] =
            sym_val(min(v[kHistOff + 3 * i + 1], kValueMask));
        const uint32_t hb = v[kHistOff + 3 * i + 2];
        uint32_t hb_new = 0;
#pragma unroll
        for (int q = 0; q < kC; ++q)
          hb_new |= ((hb >> (2 * sigma(q))) & 3u) << (2 * q);
        c[kHistOff + 3 * j + 2] = hb_new;
      }
      // The network rewritten, then sorted again (an insertion sort
      // unrolled into a network; the padding is kEmpty, which sorts last).
      uint32_t net[kMaxE];
#pragma unroll
      for (int i = 0; i < kMaxE; ++i) {
        const uint32_t x = i < e ? v[kNetOff + i] : kEmpty;
        net[i] = x == kEmpty ? x : sym_env(x);
      }
#pragma unroll
      for (int a = 1; a < kMaxE; ++a) {
#pragma unroll
        for (int b = a; b > 0; --b) {
          const uint32_t lo = min(net[b - 1], net[b]);
          const uint32_t hi = max(net[b - 1], net[b]);
          net[b - 1] = lo;
          net[b] = hi;
        }
      }
#pragma unroll
      for (int i = 0; i <= kMaxE; ++i)
        c[kNetOff + i] = i < e ? net[i] : v[kNetOff + i];
      // Keep the lexicographically smaller row.
      bool decided = false, less = false;
#pragma unroll
      for (int j = 0; j < kMaxW; ++j) {
        if (j < width() && !decided && c[j] != v[j]) {
          decided = true;
          less = c[j] < v[j];
        }
      }
      if (less) {
#pragma unroll
        for (int j = 0; j < kMaxW; ++j) v[j] = c[j];
      }
    }
  }
};

}  // namespace sr
