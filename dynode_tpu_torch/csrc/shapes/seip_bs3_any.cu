// Adaptive lockstep Bogacki-Shampine 3(2) of the SEIP ensemble at any shape (A, J, K, M,
// L, seasonal): one warp per member, one CTA of block_b warps per lockstep block.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/seip_pallas.py::_seip_kernel_adaptive
// (launched by _solve_adaptive, entry seip_ensemble_solve_adaptive) at every shape but
// the production one, which ../seip_bs3.cu serves, with the same semantics and numerics:
// the block shares one (t, dt); each attempt runs BS3's stages with the RHS of
// seip_any.cuh; the block's error norm is the max over its members of each member's
// scaled RMS error; the factor is clip(0.9 * exp(log(norm) * (-1/3)), 0.2, 10); dt is
// clamped to land on each save point and an accepted clamped step keeps its dt; an
// interval gets steps_per_save attempts (the first max(4 * steps_per_save, 32)), a block
// that runs out saves NaN for it and counts it; FSAL keeps the last stage after an
// accept. The unit is compiled with -fmad=false and IEEE division and square root, as
// ../seip_bs3.cu is (ops/_build.py), and the member norm is summed as the plain version
// (ops/seip.py::_member_norm) sums it at these shapes: a lane's values of S over its
// cells and m, then of E, I and C over its cells and l, then a xor butterfly 16, 8, 4,
// 2, 1. So both take the same decisions.
//
// Design: the production kernel's, at any shape and with block_b a runtime width (at
// most kMaxBlock warps): each warp computes the attempt's four time rows into its own
// shared slot, the block max is a warp reduction then a shared-memory reduction after
// one barrier (double-buffered), and every thread takes the same scalar decision. Warps
// past the batch shadow the last member, join every barrier and shuffle, and are left
// out of the max and the saves.

#include <cuda_runtime.h>

#include <cstddef>

#include "seip_any.cuh"

namespace dynode_seip_any {

constexpr int kMaxBlock = 16;  // warps per CTA, the widest lockstep block

// Floats of a warp's part of shared memory: its slab and the attempt's four time rows.
template <int A, int J, int K, int M, int L>
__host__ __device__ constexpr int bs3_warp_floats() {
  using D = Dims<A, J, K, M, L>;
  return D::kSlab + (4 * D::kRow + 3) / 4 * 4;
}

template <int A, int J, int K, int M, int L>
__host__ __device__ constexpr int bs3_smem_floats(int block_b) {
  // the constants, the warps' parts, then two buffers of the members' norms and flags
  return ConstLayout<A, J, K, M, L>::kShared + block_b * bs3_warp_floats<A, J, K, M, L>() + 4 * kMaxBlock;
}

template <int A, int J, int K, int M, int L>
__device__ __forceinline__ float lane_sq(const Cells<A, J, K, M, L>& er, const Cells<A, J, K, M, L>& y,
                                         const Cells<A, J, K, M, L>& yn, float atol, float rtol, int lane) {
  constexpr int P = Dims<A, J, K, M, L>::kPerLane;
  float sq = 0.0f;
  bool first = true;
  auto add = [&](float e, float a, float b) {
    const float r = e / (atol + rtol * fmaxf(fabsf(a), fabsf(b)));
    sq = first ? r * r : sq + r * r;
    first = false;
  };
#pragma unroll
  for (int n = 0; n < P; ++n) {
    if (cell_of<A, J, K, M, L>(lane, n) < 0) continue;
#pragma unroll
    for (int m = 0; m < M; ++m) add(er.s[n][m], y.s[n][m], yn.s[n][m]);
  }
#pragma unroll
  for (int n = 0; n < P; ++n) {
    if (cell_of<A, J, K, M, L>(lane, n) < 0) continue;
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.e[n][l], y.e[n][l], yn.e[n][l]);
  }
#pragma unroll
  for (int n = 0; n < P; ++n) {
    if (cell_of<A, J, K, M, L>(lane, n) < 0) continue;
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.i[n][l], y.i[n][l], yn.i[n][l]);
  }
#pragma unroll
  for (int n = 0; n < P; ++n) {
    if (cell_of<A, J, K, M, L>(lane, n) < 0) continue;
#pragma unroll
    for (int l = 0; l < L; ++l) add(er.c[n][l], y.c[n][l], yn.c[n][l]);
  }
  return sq;
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
__global__ void __launch_bounds__(32 * kMaxBlock)
seip_bs3_any_kernel(const double* __restrict__ consts, int n_knots, const float* __restrict__ y0,
                    const float* __restrict__ scales, Outs outs, int* __restrict__ flags, int batch,
                    int n_saves, float save_every, float eps, float atol, float rtol, float dt0,
                    int steps_per_save) {
  using D = Dims<A, J, K, M, L>;
  extern __shared__ __align__(16) float smem[];
  const View<A, J, K, M, L> c = load_consts<A, J, K, M, L>(smem, consts, n_knots);
  const int block_b = static_cast<int>(blockDim.x / kWarp);
  const int warp = static_cast<int>(threadIdx.x / kWarp);
  const int lane = static_cast<int>(threadIdx.x % kWarp);
  float* part = smem + ConstLayout<A, J, K, M, L>::kShared + warp * bs3_warp_floats<A, J, K, M, L>();
  float* slab = part;
  float* tr = part + D::kSlab;  // the attempt's four time rows
  float* norms = smem + ConstLayout<A, J, K, M, L>::kShared + block_b * bs3_warp_floats<A, J, K, M, L>();
  int* not_finite = reinterpret_cast<int*>(norms + 2 * kMaxBlock);
  const int g = blockIdx.x * block_b + warp;
  const bool live = g < batch;
  const int member = live ? g : batch - 1;
  const size_t pos = dynode_seip::member_pos(member, batch, outs.packed);
  load_scales<A, J, K, M, L>(slab, scales, member, batch, lane);
  constexpr float inv_n = static_cast<float>(1.0 / (A * J * K * (M + 3 * L)));
  const float c29 = static_cast<float>(2.0 / 9.0);
  const float c572 = static_cast<float>(5.0 / 72.0);
  const float c49 = static_cast<float>(4.0 / 9.0);
  const float expo = static_cast<float>(-1.0 / 3.0);

  Cells<A, J, K, M, L> y, k, st, ac, er;
  load_y0(y, y0, lane);
  if (live) save_lane(outs, y, 0, pos, batch, lane, true);
  float t = 0.0f, dt = dt0;
  bool kv = false;  // k holds f(t, y) (the last accepted attempt's final stage)
  int n_acc = 0, n_rej = 0, n_bad = 0, buf = 0;
  const int k_first = max(4 * steps_per_save, 32);
#pragma unroll 1
  for (int s = 1; s < n_saves; ++s) {
    const float s_end = static_cast<float>(s) * save_every;
    const int budget = s == 1 ? k_first : steps_per_save;
#pragma unroll 1
    for (int attempt = 0; attempt < budget; ++attempt) {
      const float remaining = s_end - t;
      if (!(remaining > eps)) break;
      const float h = fminf(dt, remaining);
      const bool landing = h >= remaining - eps;
      const float h05 = 0.5f * h, h075 = 0.75f * h;
      const float ts[4] = {t, t + h05, t + h075, t + h};
      for (int i = lane; i < 4 * D::kRow; i += kWarp) {
        tr[i] = time_value<A, J, K, M, L, SEASONAL>(c, ts[i / D::kRow], i % D::kRow);
      }
      __syncwarp();
      if (!kv) rhs<A, J, K, M, L, SEASONAL>(k, y, tr, c, slab, lane);
      axpy(ac, y, h * c29, k);
      scaled(er, h * c572, k);
      axpy(st, y, h05, k);
      rhs<A, J, K, M, L, SEASONAL>(k, st, tr + D::kRow, c, slab, lane);
      axpy(ac, ac, h / 3.0f, k);
      axpy(er, er, -(h / 12.0f), k);
      axpy(st, y, h075, k);
      rhs<A, J, K, M, L, SEASONAL>(k, st, tr + 2 * D::kRow, c, slab, lane);
      axpy(ac, ac, h * c49, k);
      axpy(er, er, -(h / 9.0f), k);
      rhs<A, J, K, M, L, SEASONAL>(k, ac, tr + 3 * D::kRow, c, slab, lane);
      axpy(er, er, h / 8.0f, k);

      float sq = lane_sq(er, y, ac, atol, rtol, lane);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sq = sq + __shfl_xor_sync(kFull, sq, off);
      const float member_norm = sqrtf(sq * inv_n);
      if (lane == 0) {
        norms[buf * kMaxBlock + warp] = live ? member_norm : 0.0f;
        not_finite[buf * kMaxBlock + warp] = live && !isfinite(member_norm);
      }
      __syncthreads();
      float norm = 0.0f;
      int bad = 0;
      for (int i = 0; i < block_b; ++i) {
        norm = fmaxf(norm, norms[buf * kMaxBlock + i]);
        bad |= not_finite[buf * kMaxBlock + i];
      }
      buf ^= 1;
      const bool ok = !bad;
      float factor = 0.2f;
      if (ok) {
        const float safe = fmaxf(norm, 1e-30f);
        factor = fminf(fmaxf(0.9f * expf(logf(safe) * expo), 0.2f), 10.0f);
      }
      const bool good = ok && norm <= 1.0f;
      dt = (landing && good) ? dt : h * factor;
      if (good) {
        y = ac;
        t = landing ? s_end : t + h;
        ++n_acc;
      } else {
        ++n_rej;
      }
      kv = good;
    }
    const bool reached = t >= s_end - eps;
    n_bad += reached ? 0 : 1;
    if (live) save_lane(outs, y, s, pos, batch, lane, reached);
  }
  if (threadIdx.x == 0) {
    flags[3 * blockIdx.x + 0] = n_bad;
    flags[3 * blockIdx.x + 1] = n_acc;
    flags[3 * blockIdx.x + 2] = n_rej;
  }
}

// flags: (ceil(B / block_b), 3) int32 exhausted / accepted / rejected per block.
template <int A, int J, int K, int M, int L, bool SEASONAL>
int launch_bs3(const double* consts, int n_knots, const float* y0, const float* scales, Outs outs,
               int* flags, int batch, int block_b, int n_saves, double save_every, double rtol,
               double atol, double dt0, int steps_per_save, cudaStream_t stream) {
  if (batch < 1 || block_b < 1 || block_b > kMaxBlock || n_saves < 2 || n_knots < 0 || n_knots > kMaxKnots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (batch + block_b - 1) / block_b;
  const int threads = 32 * block_b;
  const size_t bytes = bs3_smem_floats<A, J, K, M, L>(block_b) * sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(seip_bs3_any_kernel<A, J, K, M, L, SEASONAL>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const double eps = 1e-6 * (save_every > 1.0 ? save_every : 1.0);
  seip_bs3_any_kernel<A, J, K, M, L, SEASONAL><<<blocks, threads, bytes, stream>>>(
      consts, n_knots, y0, scales, outs, flags, batch, n_saves, static_cast<float>(save_every),
      static_cast<float>(eps), static_cast<float>(atol), static_cast<float>(rtol), static_cast<float>(dt0),
      steps_per_save);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dynode_seip_any
