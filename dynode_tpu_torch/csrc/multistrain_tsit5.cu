// Constant-step Tsit5 of the multi-strain SEIRS ensemble, a team of lanes per member.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/multistrain_pallas.py::_solve_kernel
// (launched by _solve_pallas, entry ensemble_solve_tsit5). It computes what that
// kernel computes -- n_steps Tsit5 steps of the D = A + 4*A*K row multi-strain
// SEIRS (_rhs_rows), saving all D rows every save_stride steps -- but is shaped for
// Hopper instead of being carried over block by block:
//
// * A member is served by a team of T lanes (multistrain_team.cuh): T = 1 holds the
//   whole member in one thread; T = A gives each lane one age, its s and the e, i,
//   r, c of every strain of it (13 floats at A = 2, K = 3), and the lanes trade
//   only the contact mixing's i and 1 / N by __shfl_sync. The state, the six stage
//   vectors, the rates and the contact rows live in registers; the kernel reads
//   y0, the rates and the contact matrix once and writes only the save grid
//   (out is (n_saves, D, B), member fastest, so a lane's store sits beside its
//   neighbours' members).
// * What bounds it on the H100: latency and float32 issue, not bytes. HBM traffic
//   is y0, the rates and the save grid (26 floats per member per day at A = 2,
//   K = 3) against about 2,100 operations per member per step. At the main path's
//   B = 9,984 one member per thread is 312 warps for the card's 528 schedulers.
//   T = A doubles the warps and cuts each one's instructions by a third (adding
//   eight shuffles per RHS), but each lane still runs its age's whole dependent
//   chain of a stage -- the population sum, an IEEE division, the shuffles, the
//   mixing, the fluxes -- so it gains 7% there: two of its warps on a scheduler
//   (256 threads a block) take no longer than one (chip_sweep.py multistrain).
// * The launcher picks T and the block width (ops/multistrain.py::pick_team,
//   THREADS, from chip_sweep.py multistrain on an H100 80GB HBM3 at 700 W): T = A up
//   to TEAM_UP_TO members, T = 1 above, 128 threads. The batch's ragged last warp
//   is masked; there is no batch % block constraint.
//
// The Tsit5 coefficients come from the generated header dynode_tableaus.cuh,
// written by ops/_build.py from ode/solvers.py: the Python floats of the
// tableau, each narrowed to float as the JAX kernel narrows it. Expression order
// mirrors the plain version (ops/generic.py::_rk_step_rows with the Tsit5 tableau,
// ops/multistrain.py::_rhs_rows): y + dt * sum_j a_j k_j, skipping a_j == 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "dynode_tableaus.cuh"
#include "multistrain_team.cuh"

namespace {

using dynode_ms::Lane;
using dynode_ms::Order;
using dynode_ms::Team;

constexpr int kMaxThreads = 256;  // widest block the launcher asks for

template <int A, int K, int T>
__device__ __forceinline__ void save(float* __restrict__ out, const Lane<A, K, T>& l,
                                     const float (&y)[Team<A, K, T>::N], int slot, int batch) {
  using M = Team<A, K, T>;
  constexpr int D = A + 4 * A * K;
  if (!l.live) return;
  float* base = out + static_cast<size_t>(slot) * D * batch + l.member;
#pragma unroll
  for (int v = 0; v < M::N; ++v) {
    base[static_cast<size_t>(M::row(v, l.a, A, A * K)) * batch] = y[v];
  }
}

template <int A, int K, int T>
__global__ void __launch_bounds__(kMaxThreads)
multistrain_tsit5_kernel(const float* __restrict__ y0, const float* __restrict__ params,
                         const float* __restrict__ contact, float* __restrict__ out, int batch,
                         float dt, int n_steps, int save_stride) {
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
  dynode_ms::StrainRates<K> rates;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rates.v[q][k] = __ldg(params + static_cast<size_t>(q * K + k) * batch + l.member);
    }
  }
  float y[N];
#pragma unroll
  for (int v = 0; v < N; ++v) {
    y[v] = __ldg(y0 + static_cast<size_t>(M::row(v, l.a, A, A * K)) * batch + l.member);
  }
  save(out, l, y, 0, batch);

  float ks[S][N];
  float ys[N];
#pragma unroll 1
  for (int step = 1; step <= n_steps; ++step) {
    dynode_ms::rhs<A, K, T, Order::kRows>(l, y, ks[0], crow, rates);
#pragma unroll
    for (int s = 1; s < S; ++s) {
#pragma unroll
      for (int v = 0; v < N; ++v) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < s; ++j) {
          if (dynode::tsit5_a(s, j) != 0.0) {
            acc = acc + static_cast<float>(dynode::tsit5_a(s, j)) * ks[j][v];
          }
        }
        ys[v] = y[v] + dt * acc;
      }
      dynode_ms::rhs<A, K, T, Order::kRows>(l, ys, ks[s], crow, rates);
    }
#pragma unroll
    for (int v = 0; v < N; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (dynode::tsit5_b(j) != 0.0) {
          acc = acc + static_cast<float>(dynode::tsit5_b(j)) * ks[j][v];
        }
      }
      y[v] = y[v] + dt * acc;
    }
    if (step % save_stride == 0) save(out, l, y, step / save_stride, batch);
  }
}

template <int A, int K, int T>
cudaError_t launch_team(const float* y0, const float* params, const float* contact, float* out,
                        int batch, float dt, int n_steps, int save_stride, int threads,
                        cudaStream_t stream) {
  const long long lanes = (static_cast<long long>(batch) + Team<A, K, T>::kPerWarp - 1) /
                          Team<A, K, T>::kPerWarp * dynode_ms::kWarp;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  multistrain_tsit5_kernel<A, K, T><<<blocks, threads, 0, stream>>>(
      y0, params, contact, out, batch, dt, n_steps, save_stride);
  return cudaGetLastError();
}

// The teams instantiated for age count A: one lane per member, or one per age.
template <int A, int K>
cudaError_t launch(int team, const float* y0, const float* params, const float* contact,
                   float* out, int batch, float dt, int n_steps, int save_stride, int threads,
                   cudaStream_t stream) {
  if (team == 1) {
    return launch_team<A, K, 1>(y0, params, contact, out, batch, dt, n_steps, save_stride,
                                threads, stream);
  }
  if (team == A) {
    return launch_team<A, K, A>(y0, params, contact, out, batch, dt, n_steps, save_stride,
                                threads, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point. Shapes instantiated: (A, K) = (2, 3) and (3, 2), each with a team
// of 1 lane or of one lane per age; threads a block a multiple of 32 up to 256. Any
// other request returns cudaErrorInvalidValue (the Python wrapper rejects it first).
// y0: (D, B) f32, params: (4K, B) f32, contact: (A*A,) f32, out: (n_saves, D, B) f32,
// all contiguous on the current device. Returns cudaGetLastError() after launch.
extern "C" int dynode_multistrain_tsit5(int n_age, int n_strain, int team, int threads,
                                        const float* y0, const float* params,
                                        const float* contact, float* out, int batch, float dt,
                                        int n_steps, int save_stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads <= 0 || threads > kMaxThreads || threads % dynode_ms::kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_age == 2 && n_strain == 3) {
    return launch<2, 3>(team, y0, params, contact, out, batch, dt, n_steps, save_stride,
                        threads, s);
  }
  if (n_age == 3 && n_strain == 2) {
    return launch<3, 2>(team, y0, params, contact, out, batch, dt, n_steps, save_stride,
                        threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
