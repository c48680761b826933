// Constant-step RK4 of the SEIP ensemble at any shape (A, J, K, M, L, seasonal), one
// warp per member, kWidth members per CTA; and the table of its stage times' time rows.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/seip_pallas.py::_seip_kernel (launched
// by _solve, entry seip_ensemble_solve) at every shape but the production one, which
// ../seip_rk4.cu serves. It computes what that kernel computes -- n_steps classic RK4
// steps of every member's SEIP state from one shared initial state, with per-member
// per-strain transmission scales, saving the selected compartments every save_stride
// steps -- in the order of seip_pallas.py:382-408, as ../seip_rk4.cu does: step n
// starts at float(n) * dt, its stages at t + float(0.5 dt) and t + float(dt), the
// weights 0.5 dt, dt and dt / 6 rounded once from double. The RHS is seip_any.cuh.
//
// The unit is built per shape at first use (ops/_build.py's shape builds): a generated
// translation unit includes this file and instantiates launch_table / launch_rk4 for
// its shape behind extern "C" entries of its own.
//
// Design: a simple one. The table kernel writes the 3 * n_steps time rows first, on the
// same stream, as for the production kernel; the step loop reads a lane's time scalars
// from it. Saves go straight from each lane's registers to its member's columns, float32
// or bf16. The constants and kWidth warp slabs live in dynamic shared memory
// (smem_floats). What bounds it: float32 operations and the slab's latency (see
// seip_any.cuh); chip_smoke.py prints its time beside its bound.

#include <cuda_runtime.h>

#include <cstddef>

#include "seip_any.cuh"

namespace dynode_seip_any {

constexpr int kWidth = 8;  // members (warps) per CTA of the RK4 kernel

template <int A, int J, int K, int M, int L>
__host__ __device__ constexpr int rk4_smem_floats() {
  return ConstLayout<A, J, K, M, L>::kShared + kWidth * Dims<A, J, K, M, L>::kSlab;
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
__global__ void seip_table_any_kernel(const double* __restrict__ consts, int n_knots, float dtf, float h2,
                                      int n_steps, float* __restrict__ table) {
  using D = Dims<A, J, K, M, L>;
  extern __shared__ __align__(16) float smem[];
  const View<A, J, K, M, L> c = load_consts<A, J, K, M, L>(smem, consts, n_knots);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * n_steps * D::kRow) return;
  const int row = idx / D::kRow;
  const int step = row / 3, stage = row % 3;
  const float t0 = __fmul_rn(static_cast<float>(step), dtf);
  const float t = stage == 0 ? t0 : __fadd_rn(t0, stage == 1 ? h2 : dtf);
  table[idx] = time_value<A, J, K, M, L, SEASONAL>(c, t, idx % D::kRow);
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
__global__ void __launch_bounds__(32 * kWidth)
seip_rk4_any_kernel(const double* __restrict__ consts, int n_knots, const float* __restrict__ table,
                    const float* __restrict__ y0, const float* __restrict__ scales, Outs outs, int batch,
                    float dtf, float h2, float h6, int n_steps, int save_stride) {
  using D = Dims<A, J, K, M, L>;
  extern __shared__ __align__(16) float smem[];
  const View<A, J, K, M, L> c = load_consts<A, J, K, M, L>(smem, consts, n_knots);
  const int warp = static_cast<int>(threadIdx.x / kWarp);
  const int lane = static_cast<int>(threadIdx.x % kWarp);
  float* slab = smem + ConstLayout<A, J, K, M, L>::kShared + warp * D::kSlab;
  const int g0 = blockIdx.x * kWidth;
  const int g = min(g0 + warp, batch - 1);  // warps past the batch shadow the last member
  const bool live = g0 + warp < batch;
  const size_t pos = dynode_seip::member_pos(g, batch, outs.packed);
  load_scales<A, J, K, M, L>(slab, scales, g, batch, lane);

  Cells<A, J, K, M, L> y, st, k, ac;
  load_y0(y, y0, lane);
  if (live) save_lane(outs, y, 0, pos, batch, lane, true);
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    const float* rows = table + static_cast<size_t>(3 * step) * D::kRow;
    rhs<A, J, K, M, L, SEASONAL>(k, y, rows, c, slab, lane);
    ac = k;
    axpy(st, y, h2, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, rows + D::kRow, c, slab, lane);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, h2, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, rows + D::kRow, c, slab, lane);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, dtf, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, rows + 2 * D::kRow, c, slab, lane);
    axpy(ac, ac, 1.0f, k);
    axpy(y, y, h6, ac);
    if ((step + 1) % save_stride == 0 && live) save_lane(outs, y, (step + 1) / save_stride, pos, batch, lane, true);
  }
}

// Shared memory above the default 48 KB needs the kernel's attribute.
template <class F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// table: (3 * n_steps, Dims::kRow) float32, the time rows of step n's stage times.
template <int A, int J, int K, int M, int L, bool SEASONAL>
int launch_table(const double* consts, int n_knots, double dt, int n_steps, float* table,
                 cudaStream_t stream) {
  if (n_steps < 1 || n_knots < 0 || n_knots > kMaxKnots) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const int n = 3 * n_steps * Dims<A, J, K, M, L>::kRow;
  const size_t bytes = ConstLayout<A, J, K, M, L>::kShared * sizeof(float);
  const cudaError_t attr = allow_smem(seip_table_any_kernel<A, J, K, M, L, SEASONAL>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (n + kThreads - 1) / kThreads;
  const float dtf = static_cast<float>(dt), h2 = static_cast<float>(0.5 * dt);
  seip_table_any_kernel<A, J, K, M, L, SEASONAL><<<blocks, kThreads, bytes, stream>>>(
      consts, n_knots, dtf, h2, n_steps, table);
  return static_cast<int>(cudaGetLastError());
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
int launch_rk4(const double* consts, int n_knots, const float* table, const float* y0, const float* scales,
               Outs outs, int batch, double dt, int n_steps, int save_stride, cudaStream_t stream) {
  if (batch < 1 || n_steps < 1 || save_stride < 1 || n_knots < 0 || n_knots > kMaxKnots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (batch + kWidth - 1) / kWidth;
  const int threads = 32 * kWidth;
  const size_t bytes = rk4_smem_floats<A, J, K, M, L>() * sizeof(float);
  const cudaError_t attr = allow_smem(seip_rk4_any_kernel<A, J, K, M, L, SEASONAL>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float dtf = static_cast<float>(dt), h2 = static_cast<float>(0.5 * dt);
  const float h6 = static_cast<float>(dt / 6.0);
  seip_rk4_any_kernel<A, J, K, M, L, SEASONAL><<<blocks, threads, bytes, stream>>>(
      consts, n_knots, table, y0, scales, outs, batch, dtf, h2, h6, n_steps, save_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dynode_seip_any
