// Constant-step Tsit5 of the multi-strain SEIRS ensemble, one member per thread.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/multistrain_pallas.py::_solve_kernel
// (launched by _solve_pallas, entry ensemble_solve_tsit5). It computes what that
// kernel computes -- n_steps Tsit5 steps of the D = A + 4*A*K row multi-strain
// SEIRS (_rhs_rows), saving all D rows every save_stride steps -- but is shaped for
// Hopper instead of being carried over block by block:
//
// * One thread owns one ensemble member for the whole solve. Its D state floats,
//   the six stage vectors, the 4K per-member rates and the A*A contact matrix are
//   all held in registers; the kernel reads y0, the rates and the contact matrix
//   once and writes only the save grid. A save is one store per row, and
//   neighbouring threads hold neighbouring members, so every store along the
//   batch axis is coalesced (out is (n_saves, D, B), member fastest).
// * What bounds it on the H100: float32 FMAs. HBM traffic is y0, the rates and
//   the save grid (26 floats per member per day at A=2, K=3) against roughly
//   1e3 flops per member per step, so the kernel is compute- and latency-bound,
//   not memory-bound. The design keeps every intermediate in registers (no
//   shared memory, no block-wide synchronisation), fully unrolls the row and
//   stage loops (templated on A and K), and leaves the time loop rolled.
// * The live set at (2, 3) is about 7 x 26 + 16 floats. ptxas -v (CUDA 12.9,
//   sm_90a) reports 213 registers for (2, 3) and 223 for (3, 2), with no stack
//   frame and no spills; the log of each build is build/.../nvcc.log.
// * Block width: kThreads = 128 threads, chosen by a sweep on the card (see there).
//   At B = 9,984 that is 78 blocks for 132 SMs: the main path's width under-fills
//   the card, yet blocks of 32 or 64 threads, which reach more SMs, measured slower.
// * The batch's ragged last block is masked; there is no batch % block constraint.
//
// The Tsit5 coefficients come from the generated header dynode_tableaus.cuh,
// written by ops/_build.py from ode/solvers.py: the Python floats of the
// tableau, each narrowed to float as the JAX kernel narrows it. Expression order
// mirrors the plain version (ops/generic.py::_rk_step_rows with the Tsit5 tableau,
// ops/multistrain.py::_rhs_rows): y + dt * sum_j a_j k_j, skipping a_j == 0.

#include <cuda_runtime.h>

#include <cstddef>

#include "dynode_tableaus.cuh"

namespace {

// Threads per block (one member per thread). A sweep on an H100 80GB HBM3 at
// 700 W, 200 days at dt = 0.5, gave at B = 9,984: 0.669 / 0.592 / 0.583 /
// 0.825 ms for 32 / 64 / 128 / 256 threads, and at B = 655,360: 15.19 / 15.03 /
// 15.14 ms for 64 / 128 / 256. At 213 registers a thread, 128 keeps two blocks
// on an SM and is the best or level with it at both widths.
constexpr int kThreads = 128;

template <int A, int K>
struct Dims {
  static constexpr int AK = A * K;
  static constexpr int D = A + 4 * AK;
};

// d/dt of the packed rows: s (A) | e (AK) | i (AK) | r (AK) | c (AK), idx = a*K + k
template <int A, int K>
__device__ __forceinline__ void rhs_rows(const float (&y)[Dims<A, K>::D],
                                         float (&d)[Dims<A, K>::D],
                                         const float (&contact)[A * A],
                                         const float (&beta)[K], const float (&sigma)[K],
                                         const float (&gamma)[K], const float (&omega)[K]) {
  constexpr int AK = Dims<A, K>::AK;
  float inv_n[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    float tot = y[a];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = a * K + k;
      tot = tot + y[A + idx] + y[A + AK + idx] + y[A + 2 * AK + idx];
    }
    inv_n[a] = 1.0f / tot;
  }
  float ds[A];
#pragma unroll
  for (int a = 0; a < A; ++a) ds[a] = 0.0f;
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = a * K + k;
      float mixed = 0.0f;
#pragma unroll
      for (int b = 0; b < A; ++b) {
        mixed = mixed + contact[a * A + b] * y[A + AK + b * K + k] * inv_n[b];
      }
      const float foi = beta[k] * mixed;
      const float new_inf = foi * y[a];
      const float e_out = sigma[k] * y[A + idx];
      const float i_out = gamma[k] * y[A + AK + idx];
      const float r_out = omega[k] * y[A + 2 * AK + idx];
      ds[a] = ds[a] - new_inf + r_out;
      d[A + idx] = new_inf - e_out;
      d[A + AK + idx] = e_out - i_out;
      d[A + 2 * AK + idx] = i_out - r_out;
      d[A + 3 * AK + idx] = new_inf;
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) d[a] = ds[a];
}

template <int A, int K>
__device__ __forceinline__ void save_rows(float* __restrict__ out, const float (&y)[Dims<A, K>::D],
                                          int slot, int member, int batch) {
  constexpr int D = Dims<A, K>::D;
  float* base = out + static_cast<size_t>(slot) * D * batch + member;
#pragma unroll
  for (int r = 0; r < D; ++r) base[static_cast<size_t>(r) * batch] = y[r];
}

template <int A, int K>
__global__ void multistrain_tsit5_kernel(const float* __restrict__ y0,
                                         const float* __restrict__ params,
                                         const float* __restrict__ contact_in,
                                         float* __restrict__ out, int batch, float dt,
                                         int n_steps, int save_stride) {
  constexpr int D = Dims<A, K>::D;
  constexpr int S = dynode::kTsit5Stages;
  const int member = blockIdx.x * blockDim.x + threadIdx.x;
  if (member >= batch) return;

  float contact[A * A];
#pragma unroll
  for (int j = 0; j < A * A; ++j) contact[j] = __ldg(contact_in + j);
  float beta[K], sigma[K], gamma[K], omega[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = __ldg(params + static_cast<size_t>(k) * batch + member);
    sigma[k] = __ldg(params + static_cast<size_t>(K + k) * batch + member);
    gamma[k] = __ldg(params + static_cast<size_t>(2 * K + k) * batch + member);
    omega[k] = __ldg(params + static_cast<size_t>(3 * K + k) * batch + member);
  }
  float y[D];
#pragma unroll
  for (int r = 0; r < D; ++r) y[r] = __ldg(y0 + static_cast<size_t>(r) * batch + member);
  save_rows<A, K>(out, y, 0, member, batch);

  float ks[S][D];
  float ys[D];
#pragma unroll 1
  for (int step = 1; step <= n_steps; ++step) {
    rhs_rows<A, K>(y, ks[0], contact, beta, sigma, gamma, omega);
#pragma unroll
    for (int s = 1; s < S; ++s) {
#pragma unroll
      for (int r = 0; r < D; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < s; ++j) {
          if (dynode::tsit5_a(s, j) != 0.0) {
            acc = acc + static_cast<float>(dynode::tsit5_a(s, j)) * ks[j][r];
          }
        }
        ys[r] = y[r] + dt * acc;
      }
      rhs_rows<A, K>(ys, ks[s], contact, beta, sigma, gamma, omega);
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (dynode::tsit5_b(j) != 0.0) {
          acc = acc + static_cast<float>(dynode::tsit5_b(j)) * ks[j][r];
        }
      }
      y[r] = y[r] + dt * acc;
    }
    if (step % save_stride == 0) save_rows<A, K>(out, y, step / save_stride, member, batch);
  }
}

template <int A, int K>
cudaError_t launch(const float* y0, const float* params, const float* contact, float* out,
                   int batch, float dt, int n_steps, int save_stride, cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  multistrain_tsit5_kernel<A, K><<<blocks, kThreads, 0, stream>>>(
      y0, params, contact, out, batch, dt, n_steps, save_stride);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Shapes instantiated: (A, K) = (2, 3) and (3, 2); any other
// shape returns cudaErrorInvalidValue (the Python wrapper rejects it first).
// y0: (D, B) f32, params: (4K, B) f32, contact: (A*A,) f32, out: (n_saves, D, B) f32,
// all contiguous on the current device. Returns cudaGetLastError() after launch.
extern "C" int dynode_multistrain_tsit5(int n_age, int n_strain, const float* y0,
                                        const float* params, const float* contact,
                                        float* out, int batch, float dt, int n_steps,
                                        int save_stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_age == 2 && n_strain == 3) {
    return launch<2, 3>(y0, params, contact, out, batch, dt, n_steps, save_stride, s);
  }
  if (n_age == 3 && n_strain == 2) {
    return launch<3, 2>(y0, params, contact, out, batch, dt, n_steps, save_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
