// The register workload as device code, shared by its models: the
// successor of one state under one delivery, and the exact representative
// of its client-symmetry class, on a server policy.
//
// The device-code twin of the port's batch-first torch functions:
// actor_device.py::ActorDeviceModel.step (actor_net.cuh's actor_step, with
// the model's deliver), register_workload.py::RegisterWorkloadDevice
// .deliver, ._client_deliver, .build_env, .client_permutations,
// ._sym_rewrite and .representative. Those are the port of
// stateright_tpu/tpu/actor_device.py :127 (_net_effect) and :161, and
// tpu/register_workload.py :511, :537, :606, :701 and :749.
//
// A model is RegisterWorkload<P> for a server policy P (paxos.cuh,
// single_copy.cuh, abd.cuh), a stateless struct that derives from
// RegisterEnv<kC> and gives:
//   kC, kS                 clients and servers (the most servers, where
//                          the policy takes the count at run time);
//   kMinS                  (only such a policy) its least server count;
//   kServersAtRunTime      (likewise) whether the count is at run time:
//                          where kMinS < kS, or where the policy asks for
//                          it at one count (a row so wide that its one
//                          server body and codec on words in memory build
//                          in a fifth of the time);
//   kServerLanes, kMaxOut  lanes a server, sends a delivery;
//   kServerBits            packed bits of one server's lanes;
//   kExtraBits             the envelope's extra field (0: none);
//   server<D>(v, m, outs)  the delivery of envelope m to server D, in
//                          place on the row v: whether it is handled
//                          (server(v, m, outs, s, D) at s servers, in a
//                          policy that gives kMinS);
//   max_out(s)             (likewise) the sends a delivery at s servers;
//   sym_server(lane, x, sg), sym_extra(kind, extra, sg),
//   sym_internal_req(kind, req, sg)
//                          a server lane, an envelope's extra bits and an
//                          internal kind's req under the client
//                          permutation sg (the symmetry hooks; only a
//                          policy whose group is not trivial, kC > kS,
//                          needs them).
//
// Lanes, kS servers and kC clients: each server's kServerLanes lanes; each
// client's phase; each client's history triple (status, read's return,
// happened-before edges); the network, e sorted envelopes padded with
// kEmpty (all ones, a sentinel lane of the packed row); the overflow flag,
// the model's error lane. Envelope bits: dst 0:3, src 3:6, kind 6:10, req
// 10:13, value 13:13+kValueBits, extra above.
//
// Every slot's successor is computed, enabled or not, on any row: the
// arithmetic is the torch step's uint32 arithmetic, which that code keeps
// with int64 lanes and masks; here uint32_t wraps on its own. Divisions and
// remainders run only where the torch code selects them (their operand is
// then positive), and each table gather clamps as the torch one does.
//
// Runtime indices: kS and kC are compile-time constants, so the dispatch
// on the envelope's destination leaves every server lane at a constant
// index; the network (actor_net.cuh, the actor layer's network on the form
// that neither duplicates nor loses messages) is compare-and-select loops
// over kMaxE slots, and the runtime net_slots e (1 <= e <= kMaxE, the
// model's default) guards each slot as TwoPhase's n does.
//
// A policy with kServersAtRunTime takes its server count s at run time
// (kMinS <= s <= kS), so that one instance holds a range of counts; the
// client count stays a template parameter, since the symmetry's
// permutations depend on it alone. Its step and representative work on
// the row laid out at the capacity, each server's lanes at a stride of
// kServerLanes and the clients and the network after kS servers: the row
// comes in through a gather at run-time indices (to_capacity) and goes out
// through the matching scatter (from_capacity), both through a copy of the
// row in local memory. Each server, send and residue class past s is
// guarded by s; the delivery runs one server body with the server at run
// time, and the packed row takes the codec on words in memory
// (kIndexedCodec): a kernel of such an instance, with rows of up to 111
// lanes, builds in a fifth of the time of one with every index a constant
// (PERF.md section 6). A policy without it (paxos's, and the exact
// instances of the corpus's runs) runs on its row as it is, every server
// lane at a constant index.
//
// A client permutation sg packs sigma (old client index -> new) 2 bits a
// client. The representative walks the group (the permutations that keep
// every client in its residue class mod kS: all of them at one server)
// with the running least row held as the permutation that made it and its
// sorted network; each candidate's lanes before the network are computed
// and compared as it goes, and its network is rewritten and sorted only
// when that prefix does not already lose.

#pragma once

#include <cstdint>
#include <type_traits>

#include "../packing.cuh"
#include "actor_net.cuh"

namespace sr {

constexpr int bit_length(unsigned x) { return x ? 1 + bit_length(x >> 1) : 0; }
constexpr int max_int(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int factorial(int n) {
  return n <= 1 ? 1 : n * factorial(n - 1);
}

// The envelope codec and the value map of a register workload at kC
// clients, the base of every server policy.
template <int kC_>
struct RegisterEnv {
  static constexpr int kC = kC_;
  static_assert(kC >= 1 && kC <= 4, "the encoding holds 1 to 4 clients");
  static constexpr uint32_t kEmpty = 0xFFFFFFFFu;
  static constexpr int kValueBits = kC <= 3 ? 2 : 3;
  static constexpr uint32_t kValueMask = (1u << kValueBits) - 1;
  static constexpr int kExtraShift = 13 + kValueBits;
  // Message kinds: the register interface's four; a protocol's own follow.
  static constexpr uint32_t kPut = 0, kGet = 1, kPutOk = 2, kGetOk = 3;

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

  // sigma[i] of the packed permutation sg.
  static __device__ __forceinline__ uint32_t pick(uint32_t sg, uint32_t i) {
    return (sg >> (2 * i)) & 3u;
  }
  // The value map (1 + k -> 1 + sigma[k]) at a clamped index.
  static __device__ __forceinline__ uint32_t sym_val(uint32_t x,
                                                     uint32_t sg) {
    x = min(x, kValueMask);
    return x >= 1 && x <= (uint32_t)kC ? 1 + pick(sg, x - 1) : x;
  }
};

// Whether policy P takes its server count at run time (it gives kMinS),
// its least count, and the sends of a delivery at that count.
template <class P, class = void>
struct ServerRange {
  static constexpr bool kTakesCount = false;  // server<D>(v, m, outs)
  static constexpr bool kRuntime = false;
  static constexpr int kMin = P::kS;
  static constexpr int kMinOut = P::kMaxOut;
};
template <class P>
struct ServerRange<P, std::void_t<decltype(P::kMinS)>> {
  static constexpr bool kTakesCount = true;  // server(v, m, outs, s, D)
  static constexpr bool kRuntime = P::kServersAtRunTime;
  static constexpr int kMin = P::kMinS;
  static constexpr int kMinOut = P::max_out(P::kMinS);
};

template <class P>
struct RegisterWorkload {
  static constexpr int kC = P::kC, kS = P::kS;
  static constexpr int kServerLanes = P::kServerLanes, kMaxOut = P::kMaxOut;
  static constexpr bool kRuntimeS = ServerRange<P>::kRuntime;
  // Such an instance's rows (up to 111 lanes) take the codec on words in
  // memory (wave.cuh's IndexedCodec).
  static constexpr bool kIndexedCodec = kRuntimeS;
  static constexpr int kMinS = ServerRange<P>::kMin;
  // The offsets at kS servers (the layout at the capacity).
  static constexpr int kPhaseOff = kS * kServerLanes;
  static constexpr int kHistOff = kPhaseOff + kC;
  static constexpr int kNetOff = kHistOff + 3 * kC;
  // The default net_slots at s servers: max(5C + 3, C * (max_out + 2)).
  static constexpr int default_slots(int max_out) {
    return max_int(5 * kC + 3, kC * (max_out + 2));
  }
  static constexpr int kMaxE = default_slots(kMaxOut);
  static constexpr int kMaxW = kNetOff + kMaxE + 1;
  // The fewest slots at any count the instance holds.
  static constexpr int kMinFanout =
      default_slots(ServerRange<P>::kMinOut);
  static constexpr uint32_t kEmpty = P::kEmpty;
  static constexpr uint32_t kValueMask = P::kValueMask;
  // The group is trivial unless two clients share a residue class mod s.
  static constexpr bool kSymmetric = kC > kMinS;

  // Bits of a packed row at kMaxE and kS servers (lane_bits(); the most of
  // any count the instance holds), hence kMaxWords: a network lane is a
  // sentinel lane of the envelope's bits plus one, unless the envelope
  // fills 32 bits.
  static constexpr int kEnvBits = P::kExtraShift + P::kExtraBits;
  static constexpr int kNetLaneBits = kEnvBits >= 32 ? 32 : kEnvBits + 1;
  static constexpr int kRowBits = kS * P::kServerBits + 2 * kC +
                                  kC * (3 + P::kValueBits + 2 * kC) +
                                  kMaxE * kNetLaneBits + 1;
  static constexpr int kMaxWords = (kRowBits + 31) / 32;

  using Env = typename P::Env;

  int e;      // net_slots, 1 <= e <= kMaxE
  int s_run;  // servers at run time, kMinS <= s_run <= kS (kRuntimeS)

  // The server count: a constant unless the policy takes it at run time.
  __host__ __device__ int servers() const { return kRuntimeS ? s_run : kS; }
  // A server's lanes, and the row's first lane past the servers.
  __host__ __device__ int server_lanes() const {
    if constexpr (kRuntimeS)
      return P::server_lanes(s_run);
    else
      return kServerLanes;
  }
  __host__ __device__ int row_phase_off() const {
    return servers() * server_lanes();
  }

  __host__ __device__ int width() const {
    return row_phase_off() + 4 * kC + e + 1;
  }
  __host__ __device__ int fanout() const { return e; }

  // The actor layer's hooks (actor_net.cuh): no timers, and a delivered
  // envelope leaves the network, which loses nothing.
  static constexpr int kTimers = 0, kTimerOff = 0;
  static constexpr bool lossy = false, duplicating = false;

  // Delivers the f-th envelope of the row in v, in place (actor_step): the
  // delivery's effect, the envelope removed, up to kMaxOut sends inserted
  // at their rank (a send into a full list drops the largest and sets the
  // overflow lane). Returns whether the action is enabled: a real envelope
  // that its destination handles.
  __device__ __forceinline__ bool step(uint32_t (&v)[kMaxW], int f) const {
    if constexpr (kRuntimeS) {
      uint32_t u[kMaxW];
      to_capacity(v, u);
      const bool enabled = actor_step(*this, u, f);
      from_capacity(u, v);
      return enabled;
    } else {
      return actor_step(*this, v, f);
    }
  }

  // The capacity's lane k of the row v (at servers() servers), 0 where the
  // row has no such lane.
  __device__ __forceinline__ void to_capacity(const uint32_t (&v)[kMaxW],
                                              uint32_t (&u)[kMaxW]) const {
    // Indexed at run time: held in local memory.
    uint32_t t[kMaxW];
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) t[k] = v[k];
    const int s = servers(), sl = server_lanes(), off = row_phase_off();
    const int w = width();
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      int j = -1;
      if (k < kPhaseOff) {
        const int d = k / kServerLanes, l = k % kServerLanes;
        if (d < s && l < sl) j = d * sl + l;
      } else if (off + (k - kPhaseOff) < w) {
        j = off + (k - kPhaseOff);
      }
      u[k] = j >= 0 ? t[j] : 0u;
    }
  }

  // The row v of the capacity's lanes u: the inverse of to_capacity on the
  // row's lanes; v's lanes past its width stay as they are.
  __device__ __forceinline__ void from_capacity(const uint32_t (&u)[kMaxW],
                                                uint32_t (&v)[kMaxW]) const {
    uint32_t t[kMaxW];  // as in to_capacity
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) t[k] = v[k];
    const int s = servers(), sl = server_lanes(), off = row_phase_off();
    const int w = width();
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if (k < kPhaseOff) {
        const int d = k / kServerLanes, l = k % kServerLanes;
        if (d < s && l < sl) t[d * sl + l] = u[k];
      } else if (off + (k - kPhaseOff) < w) {
        t[off + (k - kPhaseOff)] = u[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) v[k] = t[k];
  }

  __device__ __forceinline__ bool on_deliver(uint32_t (&v)[kMaxW],
                                             uint32_t env,
                                             uint32_t (&outs)[kMaxOut]) const {
    const Env m = P::fields(env);
    if constexpr (kRuntimeS) {
      // One server body, its server at run time: a body a server would
      // be kS copies of the policy's largest code.
      if (m.dst < (uint32_t)s_run)
        return P::server(v, m, outs, s_run, (int)m.dst);
      return client(v, m, outs);
    } else {
      return deliver<0>(v, m, outs);
    }
  }

  // RegisterWorkloadDevice.deliver: server D's delivery when the envelope
  // is for it, the client's past the servers.
  template <int D>
  __device__ __forceinline__ bool deliver(uint32_t (&v)[kMaxW], const Env& m,
                                          uint32_t (&outs)[kMaxOut]) const {
    if constexpr (D < kS) {
      if (m.dst == (uint32_t)D) {
        if constexpr (ServerRange<P>::kTakesCount)
          return P::server(v, m, outs, kS, D);
        else
          return P::template server<D>(v, m, outs);
      }
      return deliver<D + 1>(v, m, outs);
    } else {
      return client(v, m, outs);
    }
  }

  // RegisterWorkloadDevice._client_deliver: the Put-then-Get client k =
  // dst - S and its history triple.
  __device__ __forceinline__ bool client(uint32_t (&v)[kMaxW], const Env& m,
                                         uint32_t (&outs)[kMaxOut]) const {
    const uint32_t S = (uint32_t)servers();
    const uint32_t k = m.dst - S;  // wraps for a server: never selected
    const uint32_t kc = min(k, (uint32_t)(kC - 1));
    uint32_t phase = 0;
#pragma unroll
    for (int j = 0; j < kC; ++j)
      if ((uint32_t)j == kc) phase = v[kPhaseOff + j];
    const bool req_matches = (m.req & 3u) == k && (m.req >> 2) + 1 == phase;
    const bool putok = m.kind == P::kPutOk && phase == 1 && req_matches;
    const bool getok = m.kind == P::kGetOk && phase == 2 && req_matches;
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
    outs[0] = putok ? P::env_of((m.dst + 1) % S, m.dst, P::kGet,
                                4u | min(k, 3u), 0, 0)
                    : kEmpty;
    return putok || getok;
  }

  // -- Client symmetry ------------------------------------------------------

  __device__ __forceinline__ uint32_t sym_actor(uint32_t a,
                                                uint32_t sg) const {
    const uint32_t S = (uint32_t)servers();
    return a >= S && a < S + kC ? S + P::pick(sg, a - S) : a;
  }
  static __device__ __forceinline__ uint32_t sym_req(uint32_t r,
                                                     uint32_t sg) {
    return (r & 3u) < (uint32_t)kC ? (r & 4u) | P::pick(sg, r & 3u) : r;
  }
  // One network lane under the permutation (the empty one stays).
  __device__ __forceinline__ uint32_t sym_env(uint32_t x,
                                              uint32_t sg) const {
    if (x == kEmpty) return x;
    const Env m = P::fields(x);
    return P::env_of(sym_actor(m.dst, sg), sym_actor(m.src, sg), m.kind,
                     m.kind < 4 ? sym_req(m.req, sg)
                                : P::sym_internal_req(m.kind, m.req, sg),
                     P::sym_val(m.value, sg),
                     P::sym_extra(m.kind, m.extra, sg));
  }

  // Lane j (< kNetOff) of v under sigma sg with inverse inv: new client q
  // is old client inv[q], its edges re-indexed.
  static __device__ __forceinline__ uint32_t sym_lane(
      const uint32_t (&v)[kMaxW], int j, uint32_t sg, uint32_t inv) {
    if (j < kPhaseOff) return P::sym_server(j % kServerLanes, v[j], sg);
    if (j < kHistOff) {
      const uint32_t i = P::pick(inv, j - kPhaseOff);
      uint32_t x = 0;
#pragma unroll
      for (int q = 0; q < kC; ++q)
        if ((uint32_t)q == i) x = v[kPhaseOff + q];
      return x;
    }
    const int r = (j - kHistOff) % 3;
    const uint32_t i = P::pick(inv, (j - kHistOff) / 3);
    uint32_t x = 0;
#pragma unroll
    for (int q = 0; q < kC; ++q)
      if ((uint32_t)q == i) x = v[kHistOff + 3 * q + r];
    if (r == 1) return P::sym_val(x, sg);
    if (r == 2) {
      uint32_t hb = 0;
#pragma unroll
      for (int q = 0; q < kC; ++q)
        hb |= ((x >> (2 * P::pick(inv, q))) & 3u) << (2 * q);
      return hb;
    }
    return x;
  }

  // The least encoded row of v's class, in place.
  __device__ __forceinline__ void representative(uint32_t (&v)[kMaxW]) const {
    if constexpr (kSymmetric) {
      if (kC <= servers()) return;  // a trivial group at this count
      if constexpr (kRuntimeS) {
        uint32_t u[kMaxW];
        to_capacity(v, u);
        least(u);
        from_capacity(u, v);
      } else {
        least(v);
      }
    }
  }

  // The least member of the class of the row in v, laid out at the
  // capacity: the lanes of servers past servers() are 0 in every member,
  // so they never decide a comparison.
  __device__ __forceinline__ void least(uint32_t (&v)[kMaxW]) const {
    const uint32_t S = (uint32_t)servers();
    // The running least: v itself (orig) or v under best_sg.
    bool orig = true;
    uint32_t best_sg = 0, best_inv = 0;
    uint32_t bn[kMaxE];
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) bn[i] = i < e ? v[kNetOff + i] : kEmpty;
    // Every permutation but the identity (p = 0), as its Lehmer code.
#pragma unroll 1
    for (int p = 1; p < factorial(kC); ++p) {
      uint32_t sg = 0, inv = 0, avail = 0xE4u;  // 0, 1, 2, 3
      int rest = p;
      bool in_class = true;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int fact = factorial(kC - 1 - k);
        const unsigned d = (unsigned)(rest / fact);
        rest -= (int)d * fact;
        const uint32_t x = (avail >> (2 * d)) & 3u;
        avail = (avail & ((1u << (2 * d)) - 1)) |
                ((avail >> (2 * d + 2)) << (2 * d));
        sg |= x << (2 * k);
        inv |= (uint32_t)k << (2 * x);
        in_class = in_class && x % S == (uint32_t)k % S;
      }
      if (!in_class) continue;
      // The lanes before the network, compared as they come.
      int cmp = 0;
#pragma unroll
      for (int j = 0; j < kNetOff; ++j) {
        const uint32_t c = sym_lane(v, j, sg, inv);
        const uint32_t b = orig ? v[j] : sym_lane(v, j, best_sg, best_inv);
        if (cmp == 0 && c != b) cmp = c < b ? -1 : 1;
      }
      if (cmp > 0) continue;
      // The network rewritten, then sorted again (an insertion sort
      // unrolled into a network; the padding is kEmpty, which sorts last).
      uint32_t cn[kMaxE];
#pragma unroll
      for (int i = 0; i < kMaxE; ++i)
        cn[i] = sym_env(i < e ? v[kNetOff + i] : kEmpty, sg);
#pragma unroll
      for (int a = 1; a < kMaxE; ++a) {
#pragma unroll
        for (int b = a; b > 0; --b) {
          const uint32_t lo = min(cn[b - 1], cn[b]);
          const uint32_t hi = max(cn[b - 1], cn[b]);
          cn[b - 1] = lo;
          cn[b] = hi;
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxE; ++i)
        if (i < e && cmp == 0 && cn[i] != bn[i])
          cmp = cn[i] < bn[i] ? -1 : 1;
      // The overflow lane is the same in both.
      if (cmp < 0) {
        orig = false;
        best_sg = sg;
        best_inv = inv;
#pragma unroll
        for (int i = 0; i < kMaxE; ++i) bn[i] = cn[i];
      }
    }
    if (!orig) {
      uint32_t pre[kNetOff];
#pragma unroll
      for (int j = 0; j < kNetOff; ++j)
        pre[j] = sym_lane(v, j, best_sg, best_inv);
#pragma unroll
      for (int j = 0; j < kNetOff; ++j) v[j] = pre[j];
#pragma unroll
      for (int i = 0; i < kMaxE; ++i)
        if (i < e) v[kNetOff + i] = bn[i];
    }
  }
};

// Calls fn with model M at net_slots e and s servers; `none` when M does
// not hold them.
template <class M, class Fn>
long long with_register(int e, int s, long long none, Fn&& fn) {
  if (e < 1 || e > M::kMaxE || s < M::kMinS || s > M::kS) return none;
  return fn(M{e, s});
}

}  // namespace sr
