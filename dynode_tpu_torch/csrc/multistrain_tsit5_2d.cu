// Constant-step Tsit5 of the multi-strain SEIRS ensemble on the aligned 2-D
// layout, a team of lanes per member.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/multistrain_pallas.py::_solve_kernel_2d
// (launched by _solve_pallas_2d, entry ensemble_solve_tsit5_2d). It computes what that
// kernel computes -- n_steps Tsit5 steps of the multi-strain SEIRS on the aligned
// (D2, B) state (each of the s | e | i | r | c groups padded to 8 rows), with the
// per-(age, strain)-row rates of pack_rates_2d, saving all D2 rows every save_stride
// steps with zero padding rows -- in the expression order of _rhs_2d and
// _tsit5_step_2d (ops/multistrain.py, the plain version).
//
// The TPU variant spread the model's structure over the vector unit's sublanes. On
// Hopper the structure goes over lanes only as far as it does not repeat work:
//
// * A member is served by a team of T lanes (multistrain_team.cuh, the RHS the row
//   kernel multistrain_tsit5.cu shares in its own order): T = 1 holds the whole
//   member in one thread; T = A gives each lane one age -- its s and the e, i, r, c
//   of every strain of it -- so the age's population sum, its one division and ds
//   are the lane's own, and only the mixing's i / N crosses lanes, A K shuffles
//   per RHS. One (age, strain) pair per lane, eight lanes a member, would put
//   eight shuffles on each RHS's dependent chain, a division in every lane and
//   each age's s in all of its lanes: it measured 15% slower at B = 9,984 and
//   5.4 times slower at 655,360.
// * The padding rows live nowhere but in the saves: each save writes them as zero,
//   spread over the team's lanes.
// * What bounds it on the H100: float32 issue and latency, as for the row kernel.
//   The launcher picks T and the block width as for the row kernel
//   (ops/multistrain.py::pick_team, THREADS). The batch's ragged last warp is
//   masked; there is no batch % block constraint.
// * The Tsit5 weights are the generated dynode_tableaus.cuh values; as in the JAX
//   _tsit5_step_2d, each enters as float(dt * a) with the product taken in double,
//   computed once on the host and passed by value in the kernel's parameter space.

#include <cuda_runtime.h>

#include <cstddef>

#include "dynode_tableaus.cuh"
#include "multistrain_team.cuh"

namespace {

using dynode_ms::Lane;
using dynode_ms::Order;
using dynode_ms::Team;

constexpr int kMaxThreads = 256;  // widest block the launcher asks for

struct Weights {
  float a[dynode::kTsit5Stages][dynode::kTsit5Stages];  // float(dt * a(s, j))
  float b[dynode::kTsit5Stages];                        // float(dt * b(j))
};

constexpr int blk8(int n) { return (n + 7) / 8 * 8; }

template <int A, int K>
struct Layout {
  static constexpr int AK = A * K;
  static constexpr int SA = blk8(A);
  static constexpr int SAK = blk8(AK);
  static constexpr int D2 = SA + 4 * SAK;
  static constexpr int kPad = (SA - A) + 4 * (SAK - AK);  // zero rows of a save
  // the j-th padding row: s rows past A, then each group's rows past A*K
  __host__ __device__ static constexpr int pad_row(int j) {
    return j < SA - A ? A + j
                      : SA + (j - (SA - A)) / (SAK - AK) * SAK + AK + (j - (SA - A)) % (SAK - AK);
  }
  static_assert(SAK > AK, "every group has padding rows");
};

template <int A, int K, int T>
__device__ __forceinline__ void save(float* __restrict__ out, const Lane<A, K, T>& l,
                                     const float (&y)[Team<A, K, T>::N], int slot, int batch) {
  using L = Layout<A, K>;
  using M = Team<A, K, T>;
  if (!l.live) return;
  float* base = out + static_cast<size_t>(slot) * L::D2 * batch + l.member;
#pragma unroll
  for (int v = 0; v < M::N; ++v) {
    base[static_cast<size_t>(M::row(v, l.a, L::SA, L::SAK)) * batch] = y[v];
  }
#pragma unroll
  for (int j = 0; j < L::kPad; ++j) {
    if (j % T == l.a) base[static_cast<size_t>(L::pad_row(j)) * batch] = 0.0f;
  }
}

template <int A, int K, int T>
__global__ void __launch_bounds__(kMaxThreads)
multistrain_tsit5_2d_kernel(const float* __restrict__ y0, const float* __restrict__ rates_in,
                            const float* __restrict__ contact, float* __restrict__ out,
                            int batch, Weights w, int n_steps, int save_stride) {
  using L = Layout<A, K>;
  using M = Team<A, K, T>;
  constexpr int N = M::N;
  constexpr int G = M::G;
  constexpr int S = dynode::kTsit5Stages;
  const Lane<A, K, T> l = dynode_ms::lane_of<A, K, T>(batch);

  float crow[G][A];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int b = 0; b < A; ++b) crow[g][b] = __ldg(contact + (l.a + g) * A + b);
  }
  dynode_ms::RowRates<G, K> rates;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int row = q * L::SAK + (l.a + g) * K + k;
        rates.v[q][g][k] = __ldg(rates_in + static_cast<size_t>(row) * batch + l.member);
      }
    }
  }
  float y[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    y[v] = __ldg(y0 + static_cast<size_t>(M::row(v, l.a, L::SA, L::SAK)) * batch + l.member);
  }
  save(out, l, y, 0, batch);

  float ks[S][N];
#pragma unroll 1
  for (int step = 1; step <= n_steps; ++step) {
    dynode_ms::rhs<A, K, T, Order::k2D>(l, y, ks[0], crow, rates);
#pragma unroll
    for (int s = 1; s < S; ++s) {
      float ys[N];
#pragma unroll
      for (int v = 0; v < N; ++v) ys[v] = y[v];
#pragma unroll
      for (int j = 0; j < s; ++j) {
        if (dynode::tsit5_a(s, j) != 0.0) {
#pragma unroll
          for (int v = 0; v < N; ++v) ys[v] = ys[v] + w.a[s][j] * ks[j][v];
        }
      }
      dynode_ms::rhs<A, K, T, Order::k2D>(l, ys, ks[s], crow, rates);
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (dynode::tsit5_b(j) != 0.0) {
#pragma unroll
        for (int v = 0; v < N; ++v) y[v] = y[v] + w.b[j] * ks[j][v];
      }
    }
    if (step % save_stride == 0) save(out, l, y, step / save_stride, batch);
  }
}

template <int A, int K, int T>
cudaError_t launch_team(const float* y0, const float* rates, const float* contact, float* out,
                        int batch, const Weights& w, int n_steps, int save_stride, int threads,
                        cudaStream_t stream) {
  const long long lanes = (static_cast<long long>(batch) + Team<A, K, T>::kPerWarp - 1) /
                          Team<A, K, T>::kPerWarp * dynode_ms::kWarp;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  multistrain_tsit5_2d_kernel<A, K, T><<<blocks, threads, 0, stream>>>(
      y0, rates, contact, out, batch, w, n_steps, save_stride);
  return cudaGetLastError();
}

// The teams instantiated for age count A: one lane per member, or one per age.
template <int A, int K>
cudaError_t launch(int team, const float* y0, const float* rates, const float* contact,
                   float* out, int batch, const Weights& w, int n_steps, int save_stride,
                   int threads, cudaStream_t stream) {
  if (team == 1) {
    return launch_team<A, K, 1>(y0, rates, contact, out, batch, w, n_steps, save_stride,
                                threads, stream);
  }
  if (team == A) {
    return launch_team<A, K, A>(y0, rates, contact, out, batch, w, n_steps, save_stride,
                                threads, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point. Shapes instantiated: (A, K) = (2, 3) and (3, 2), each with a team
// of 1 lane or of one lane per age; threads a block a multiple of 32 up to 256. Any
// other request returns cudaErrorInvalidValue (the Python wrapper rejects it first).
// y0: (D2, B) f32, rates: (4 * 8, B) f32, contact: (A*A,) f32, out: (n_saves, D2, B)
// f32, all contiguous on the current device; dt in double, as the JAX kernel forms
// dt * a in double. Returns cudaGetLastError() after the launch.
extern "C" int dynode_multistrain_tsit5_2d(int n_age, int n_strain, int team, int threads,
                                           const float* y0, const float* rates,
                                           const float* contact, float* out, int batch,
                                           double dt, int n_steps, int save_stride,
                                           void* stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % dynode_ms::kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Weights w{};
  for (int s = 0; s < dynode::kTsit5Stages; ++s) {
    for (int j = 0; j < dynode::kTsit5Stages; ++j) {
      w.a[s][j] = static_cast<float>(dt * dynode::tsit5_a(s, j));
    }
    w.b[s] = static_cast<float>(dt * dynode::tsit5_b(s));
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_age == 2 && n_strain == 3) {
    return launch<2, 3>(team, y0, rates, contact, out, batch, w, n_steps, save_stride, threads,
                        st);
  }
  if (n_age == 3 && n_strain == 2) {
    return launch<3, 2>(team, y0, rates, contact, out, batch, w, n_steps, save_stride, threads,
                        st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
