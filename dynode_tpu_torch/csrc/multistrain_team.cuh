// The multi-strain SEIRS right-hand side shared by the two constant-step Tsit5
// kernels (multistrain_tsit5.cu, multistrain_tsit5_2d.cu), for a team of T lanes
// per ensemble member.
//
// * T = 1: one lane holds the whole member, all A ages (the one-member-per-thread
//   layout). T = A: lane a of a team holds age a.
// * A lane holds s of each of its ages and e, i, r and c of every strain of them:
//   G * (1 + 4K) floats, G = A for T = 1 and 1 otherwise, in the packed row order
//   restricted to its ages (s | e | i | r | c, index g * K + k).
// * Everything but the contact mixing is local to an age: its population sum, its
//   one division, ds. The mixing of age a reads i[b, k] and 1 / N[b] (row order) or
//   i[b, k] / N[b] (2-D order) of every age b: a lane reads them by __shfl_sync
//   from lane b of its team, its own included, and sums b = 0 .. A - 1 in order, as
//   the plain versions do. At (A, K) = (2, 3) that is A (K + 1) = 8 shuffles per
//   RHS in the row order and A K = 6 in the 2-D order. (Fetching only the A - 1
//   other ages and picking each age's value by a select measured 1% slower.)
// * A warp serves 32 / T members (10 at T = 3, with its last 2 lanes idle; teams
//   of 4 with one idle lane each measured 29-48% slower at B = 9,984). Idle lanes,
//   and lanes of members past the batch, shadow a live member, take part in every
//   shuffle (each uses the full mask) and store nothing.
//
// Both expression orders are the plain versions' (ops/multistrain.py): kRows is
// _rhs_rows, k2D is _rhs_2d.

#pragma once

#include <cuda_runtime.h>

namespace dynode_ms {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

enum class Order { kRows, k2D };

template <int A, int K, int T>
struct Team {
  static_assert(T == 1 || T == A, "a team is one lane or one lane per age");
  static constexpr int G = T == 1 ? A : 1;    // ages a lane holds
  static constexpr int N = G * (1 + 4 * K);   // floats of state a lane holds
  static constexpr int kPerWarp = kWarp / T;  // members a warp serves

  // where a lane keeps compartment value (g, k): s | e | i | r | c
  __host__ __device__ static constexpr int s(int g) { return g; }
  __host__ __device__ static constexpr int e(int g, int k) { return G + g * K + k; }
  __host__ __device__ static constexpr int i(int g, int k) { return G + (G + g) * K + k; }
  __host__ __device__ static constexpr int r(int g, int k) { return G + (2 * G + g) * K + k; }
  __host__ __device__ static constexpr int c(int g, int k) { return G + (3 * G + g) * K + k; }

  // Global row of a lane's value v in a layout of an s group of `srows` rows and
  // e / i / r / c groups of `grows` rows each; age0 is the lane's first age.
  __host__ __device__ static constexpr int row(int v, int age0, int srows, int grows) {
    return v < G ? age0 + v : srows + (v - G) / (G * K) * grows + age0 * K + (v - G) % (G * K);
  }
};

// Where a lane sits: its member and its age.
template <int A, int K, int T>
struct Lane {
  int member;  // the member it serves (a live one, shadowed past the batch)
  bool live;   // its member is in the batch and it stores
  int a;       // first age it holds: 0 for T = 1, its place in the team for T = A
  int team0;   // the warp lane of the team's age 0
};

template <int A, int K, int T>
__device__ __forceinline__ Lane<A, K, T> lane_of(int batch) {
  using M = Team<A, K, T>;
  Lane<A, K, T> l;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int slot = lane / T;
  const long long member = warp * M::kPerWarp + slot;
  l.live = slot < M::kPerWarp && member < batch;
  l.member = l.live ? static_cast<int>(member) : batch - 1;
  l.a = lane % T;
  l.team0 = slot * T;
  return l;
}

// Rates of a member by strain, (4K, B) rows beta | sigma | gamma | omega.
template <int K>
struct StrainRates {
  float v[4][K];
  __device__ __forceinline__ float operator()(int q, int, int k) const { return v[q][k]; }
};

// Rates by (age, strain) row, the aligned layout of pack_rates_2d.
template <int G, int K>
struct RowRates {
  float v[4][G][K];
  __device__ __forceinline__ float operator()(int q, int g, int k) const { return v[q][g][k]; }
};

// all[b] = the team's values of age b, in age order, read from lane b of the team.
template <int A, int K, int T, int W>
__device__ __forceinline__ void gather(const Lane<A, K, T>& l, const float (&own)[W],
                                       float (&all)[A][W]) {
#pragma unroll
  for (int b = 0; b < A; ++b) {
#pragma unroll
    for (int w = 0; w < W; ++w) all[b][w] = __shfl_sync(kFull, own[w], l.team0 + b);
  }
}

// d/dt of a lane's values. crow[g] is row (first age + g) of the contact matrix.
template <int A, int K, int T, Order O, class Rates>
__device__ __forceinline__ void rhs(const Lane<A, K, T>& l, const float (&y)[Team<A, K, T>::N],
                                    float (&d)[Team<A, K, T>::N],
                                    const float (&crow)[Team<A, K, T>::G][A], const Rates& p) {
  using M = Team<A, K, T>;
  constexpr int G = M::G;
  if constexpr (O == Order::kRows) {
    // _rhs_rows: mixed = sum_b contact[a][b] * i[b, k] * inv_n[b]
    float mine[G][K + 1];  // i of each strain, then 1 / N, per age held
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tot = y[M::s(g)];
#pragma unroll
      for (int k = 0; k < K; ++k) tot = tot + y[M::e(g, k)] + y[M::i(g, k)] + y[M::r(g, k)];
      mine[g][K] = 1.0f / tot;
#pragma unroll
      for (int k = 0; k < K; ++k) mine[g][k] = y[M::i(g, k)];
    }
    float all[A][K + 1];
    if constexpr (T == 1) {
#pragma unroll
      for (int b = 0; b < A; ++b) {
#pragma unroll
        for (int w = 0; w <= K; ++w) all[b][w] = mine[b][w];
      }
    } else {
      gather<A, K, T, K + 1>(l, mine[0], all);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ds = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float mixed = 0.0f;
#pragma unroll
        for (int b = 0; b < A; ++b) mixed = mixed + crow[g][b] * all[b][k] * all[b][K];
        const float foi = p(0, g, k) * mixed;
        const float new_inf = foi * y[M::s(g)];
        const float e_out = p(1, g, k) * y[M::e(g, k)];
        const float i_out = p(2, g, k) * y[M::i(g, k)];
        const float r_out = p(3, g, k) * y[M::r(g, k)];
        ds = ds - new_inf + r_out;
        d[M::e(g, k)] = new_inf - e_out;
        d[M::i(g, k)] = e_out - i_out;
        d[M::r(g, k)] = i_out - r_out;
        d[M::c(g, k)] = new_inf;
      }
      d[M::s(g)] = ds;
    }
  } else {
    // _rhs_2d: mixed = sum_b contact[a][b] * (i[b, k] * inv_n[b])
    float mine[G][K];  // i * (1 / N) of each strain, per age held
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pop = y[M::e(g, 0)] + y[M::i(g, 0)] + y[M::r(g, 0)];
#pragma unroll
      for (int k = 1; k < K; ++k) pop = pop + (y[M::e(g, k)] + y[M::i(g, k)] + y[M::r(g, k)]);
      const float inv_n = 1.0f / (y[M::s(g)] + pop);
#pragma unroll
      for (int k = 0; k < K; ++k) mine[g][k] = y[M::i(g, k)] * inv_n;
    }
    float all[A][K];
    if constexpr (T == 1) {
#pragma unroll
      for (int b = 0; b < A; ++b) {
#pragma unroll
        for (int k = 0; k < K; ++k) all[b][k] = mine[b][k];
      }
    } else {
      gather<A, K, T, K>(l, mine[0], all);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ds = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float mixed = crow[g][0] * all[0][k];
#pragma unroll
        for (int b = 1; b < A; ++b) mixed = mixed + crow[g][b] * all[b][k];
        const float new_inf = p(0, g, k) * mixed * y[M::s(g)];
        const float e_out = p(1, g, k) * y[M::e(g, k)];
        const float i_out = p(2, g, k) * y[M::i(g, k)];
        const float r_out = p(3, g, k) * y[M::r(g, k)];
        const float net = r_out - new_inf;
        ds = k == 0 ? net : ds + net;
        d[M::e(g, k)] = new_inf - e_out;
        d[M::i(g, k)] = e_out - i_out;
        d[M::r(g, k)] = i_out - r_out;
        d[M::c(g, k)] = new_inf;
      }
      d[M::s(g)] = ds;
    }
  }
}

}  // namespace dynode_ms
