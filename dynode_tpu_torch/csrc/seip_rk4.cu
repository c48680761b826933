// Constant-step RK4 of the SEIP ensemble, one warp per member, W members per CTA.
//
// Replaces the Pallas TPU kernel dynode_tpu/ops/seip_pallas.py::_seip_kernel (launched
// by _solve, entry seip_ensemble_solve). It computes what that kernel computes --
// n_steps classic RK4 steps of the 640-float SEIP state of every member, from one
// shared initial state, with per-member per-strain transmission scales, saving the
// selected compartments every save_stride steps -- in the order of
// seip_pallas.py:382-408: step n starts at float(n) * dt; its stages are at t,
// t + float(0.5 dt), t + float(dt); the weights 0.5 dt, dt and dt / 6 are formed in
// double on the host and rounded once. The RHS is seip_rhs.cuh.
//
// What bounds it on the H100: float32 operations. One RHS is about 5.4k operations
// per member, the time scalars apart, and an RK4 step about 29.8k, so 200 days at
// dt = 0.5 and B = 32,768 are about 3.9e11 operations (5.8 ms at 67 TFLOP/s), against
// 3.4 GB of C-only float32 saves (1.0 ms at 3.35 TB/s); chip_smoke.py counts both from
// the plain version.
//
// Design. The TPU kernel kept a 1,024-member tile of the state and its four RK groups
// resident in VMEM and computed the time scalars once per tile on its scalar unit. A
// thread here has at most 255 registers, so one member per thread would spill about
// 10 KB of live state; a warp per member spreads it over 32 lanes instead
// (seip_rhs.cuh): 20 floats per group per lane, 80 for the four groups (y, stage input,
// stage derivative, accumulator), in registers.
//   * Time scalars: every member shares the three stage times of a step, so a small
//     kernel (seip_time_table_kernel) writes the time rows of all 3 * n_steps stage
//     times first, on the same stream, into scratch the wrapper allocates; the step
//     loop reads a lane's six values per stage with two vector loads (the next step's
//     first stage one step ahead) and computes no cosine, exponential or sine.
//     t + dt is not always float(n + 1) * dt in float32, hence three rows per step.
//   * Saves in float32 go straight from each lane's registers to its member's
//     columns (save_lane), with no barrier: a CTA barrier waits for the slowest of
//     the CTA's warps, which costs more than the scattered 4-byte stores. Saves in
//     bf16 would dirty a 32-byte sector per 2-byte store, so they go through shared
//     memory: each warp stages its member's values of every saved compartment,
//     member-major, the CTA synchronises once, and every thread then writes its
//     share of the value rows, 8 consecutive members with one 16-byte store, and
//     goes straight on to the next step; consecutive members are contiguous in both
//     layouts (the tile layout in runs of 128). Two stage buffers alternate, so a save's barrier also tells every thread that the
//     buffer it stages into next was read out: one barrier per save. They are
//     dynamic shared memory sized to the saved compartments. A ragged last CTA,
//     or a batch that breaks the vector alignment, writes member by member, still
//     coalesced along the row. Warps past the batch shadow the last member and
//     write nothing.
//   * W = 16 members per CTA (kWidth), the fastest of 4, 8 and 16 with bf16 saves, whose
//     rows it writes in whole 32-byte sectors. __launch_bounds__ asks for 16 / W CTAs
//     per SM, 16 warps: at most 128 registers a thread (20 and 24 warps, at 96 and 80,
//     spilled hundreds of bytes and ran slower). chip_smoke.py prints the registers
//     and spills from ptxas.

#include <cuda_runtime.h>

#include <cstdint>

#include "seip_rhs.cuh"

namespace {

using namespace dynode_seip;

constexpr int kWidth = 16;  // members (warps) per CTA

// A member's staged save slot: the saved compartments' values in the order S, E, I, C,
// padded by 4 floats so that a row of W members' value v reads from distinct banks
// (every compartment is a multiple of 128 values).
template <int A, int J, int K, int M, int L>
__host__ __device__ inline int stage_row(const Outs& o) {
  const int n_eic = (o.p[1] != nullptr) + (o.p[2] != nullptr) + (o.p[3] != nullptr);
  return (o.p[0] != nullptr ? A * J * K * M : 0) + n_eic * A * J * K * L + 4;
}

template <int A, int J, int K, int M, int L, bool SEASONAL>
__global__ void seip_time_table_kernel(const __grid_constant__ Consts<A, J, K, M, L> c, float dtf,
                                       float h2, int n_steps, float* __restrict__ table) {
  using T = TimeLayout<A, K, L>;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * n_steps * T::kRow) return;
  const int row = idx / T::kRow;
  const int step = row / 3, stage = row % 3;
  const float t0 = __fmul_rn(static_cast<float>(step), dtf);
  const float t = stage == 0 ? t0 : __fadd_rn(t0, stage == 1 ? h2 : dtf);
  table[idx] = time_value<A, J, K, M, L, SEASONAL>(c, t, idx % T::kRow);
}

// Write value rows [0, nv) of bf16 save slot `slot` for members g0 .. g0 + W - 1 from
// the staged rows: value v of member m is stage[m * row + v].
template <int W>
__device__ __forceinline__ void write_rows(void* base, int packed, int nv, int slot,
                                           const float* stage, int row, int g0, int batch) {
  constexpr int kThreads = 32 * W;
  constexpr int E = 8;  // members per 16-byte store
  static_assert(W % E == 0, "a CTA's members fill whole 16-byte stores");
  struct alignas(2 * E) Chunk {
    __nv_bfloat162 h[E / 2];
  };
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(base);
  const size_t first = static_cast<size_t>(slot) * nv;  // the slot's first value row
  const size_t pos0 = member_pos(g0, batch, packed);
  const int tid = static_cast<int>(threadIdx.x);
  if (g0 + W <= batch && batch % E == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0) {
    for (int it = tid; it < nv * (W / E); it += kThreads) {
      const int v = it / (W / E), m0 = (it % (W / E)) * E;
      Chunk chunk;
#pragma unroll
      for (int p = 0; p < E / 2; ++p) {
        chunk.h[p] = __floats2bfloat162_rn(stage[(m0 + 2 * p) * row + v], stage[(m0 + 2 * p + 1) * row + v]);
      }
      *reinterpret_cast<Chunk*>(out + (first + v) * batch + pos0 + m0) = chunk;
    }
    return;
  }
  for (int it = tid; it < nv * W; it += kThreads) {
    const int v = it / W, m = it % W;
    if (g0 + m < batch) out[(first + v) * batch + pos0 + m] = __float2bfloat16_rn(stage[m * row + v]);
  }
}

// Save bf16 slot `slot` of every selected compartment for the CTA's members through
// `stage`, W staged rows of `row` floats: the buffer the previous save did not use.
template <int A, int J, int K, int M, int L, int W>
__device__ __forceinline__ void save_cta(const Outs& o, const Lane<M, L>& y, int slot, float* stage,
                                         int row, int g0, int batch, int warp,
                                         const Where<A, J, K>& w) {
  constexpr int NS = A * J * K * M;
  constexpr int NE = A * J * K * L;
  static_assert(M == 4 && 2 * L == 4, "a lane stages its values of a compartment as float4s");
  float* mine = stage + warp * row;
  int v0 = 0;
  if (o.p[0]) {
    // value (cell * M + m) with cell = 2 * lane + q
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      *reinterpret_cast<float4*>(mine + (2 * w.lane + q) * M) =
          make_float4(y.s[q][0], y.s[q][1], y.s[q][2], y.s[q][3]);
    }
    v0 = NS;
  }
#pragma unroll
  for (int comp = 1; comp < 4; ++comp) {
    // value v0 + cell * L + l, with cell * L + l = 4 * lane + 2 * q + l
    const float(&x)[2][L] = comp == 1 ? y.e : (comp == 2 ? y.i : y.c);
    if (o.p[comp]) {
      *reinterpret_cast<float4*>(mine + v0 + 4 * w.lane) = make_float4(x[0][0], x[0][1], x[1][0], x[1][1]);
      v0 += NE;
    }
  }
  __syncthreads();
  v0 = 0;
#pragma unroll
  for (int comp = 0; comp < 4; ++comp) {
    if (!o.p[comp]) continue;
    const int nv = comp == 0 ? NS : NE;
    write_rows<W>(o.p[comp], o.packed, nv, slot, stage + v0, row, g0, batch);
    v0 += nv;
  }
}

template <int A, int J, int K, int M, int L, bool SEASONAL, int W>
__global__ void __launch_bounds__(32 * W, 16 / W)
seip_rk4_kernel(const __grid_constant__ Consts<A, J, K, M, L> cp, const float* __restrict__ table,
                const float* __restrict__ y0, const float* __restrict__ scales, Outs outs,
                int batch, float dtf, float h2, float h6, int n_steps, int save_stride) {
  using T = TimeLayout<A, K, L>;
  __shared__ Consts<A, J, K, M, L> c;
  __shared__ WarpSlab<A, L> slabs[W];
  extern __shared__ __align__(16) float stages[];  // bf16 saves: two stage buffers, by slot parity
  const int row = stage_row<A, J, K, M, L>(outs);
  load_consts(c, cp);
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int g0 = blockIdx.x * W;
  const int g = min(g0 + warp, batch - 1);  // warps past the batch shadow the last member
  const Where<A, J, K> w(static_cast<int>(threadIdx.x % 32));
  const Routes routes = lane_routes(c, w);
  WarpSlab<A, L>& slab = slabs[warp];
  const bool live = g0 + warp < batch;
  const size_t pos = member_pos(g, batch, outs.packed);
  float scale[L];
#pragma unroll
  for (int l = 0; l < L; ++l) scale[l] = __ldg(scales + static_cast<size_t>(l) * batch + g);

  Lane<M, L> y, st, k, ac;
  load_y0(y, y0, w);
  if (!outs.bf16) {
    if (live) save_lane(outs, y, 0, pos, batch, w, true);
  } else {
    save_cta<A, J, K, M, L, W>(outs, y, 0, stages, row, g0, batch, warp, w);
  }
  LaneTime<L> t_start = lane_time<A, J, K, L>(table, w);
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    const float* rows = table + static_cast<size_t>(3 * step) * T::kRow;
    const LaneTime<L> t_next = lane_time<A, J, K, L>(step + 1 < n_steps ? rows + 3 * T::kRow : rows, w);
    rhs<A, J, K, M, L, SEASONAL>(k, y, t_start, scale, c, routes, slab, w);
    ac = k;
    axpy(st, y, h2, k);
    const LaneTime<L> t_half = lane_time<A, J, K, L>(rows + T::kRow, w);
    rhs<A, J, K, M, L, SEASONAL>(k, st, t_half, scale, c, routes, slab, w);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, h2, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, t_half, scale, c, routes, slab, w);
    axpy(ac, ac, 2.0f, k);
    axpy(st, y, dtf, k);
    rhs<A, J, K, M, L, SEASONAL>(k, st, lane_time<A, J, K, L>(rows + 2 * T::kRow, w), scale, c, routes,
                                 slab, w);
    axpy(ac, ac, 1.0f, k);
    axpy(y, y, h6, ac);
    t_start = t_next;
    if ((step + 1) % save_stride == 0) {
      const int slot = (step + 1) / save_stride;
      if (!outs.bf16) {
        if (live) save_lane(outs, y, slot, pos, batch, w, true);
      } else {
        save_cta<A, J, K, M, L, W>(outs, y, slot, stages + (slot & 1) * W * row, row, g0, batch, warp, w);
      }
    }
  }
}

template <int A, int J, int K, int M, int L, bool SEASONAL, int W>
int launch(const Consts<A, J, K, M, L>& c, const float* table, const float* y0, const float* scales,
           Outs outs, int batch, double dt, int n_steps, int save_stride, cudaStream_t stream) {
  const int blocks = (batch + W - 1) / W;
  const size_t stage_bytes = outs.bf16 ? 2 * W * stage_row<A, J, K, M, L>(outs) * sizeof(float) : 0;
  const cudaError_t attr = cudaFuncSetAttribute(seip_rk4_kernel<A, J, K, M, L, SEASONAL, W>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(stage_bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  seip_rk4_kernel<A, J, K, M, L, SEASONAL, W><<<blocks, 32 * W, stage_bytes, stream>>>(
      c, table, y0, scales, outs, batch, static_cast<float>(dt), static_cast<float>(0.5 * dt),
      static_cast<float>(dt / 6.0), n_steps, save_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Instantiated for (A, J, K, M, L, seasonal) = (4, 4, 4, 4, 2, 1), the
// production configuration; any other shape, or more than kMaxKnots spline knots,
// returns cudaErrorInvalidValue (the Python wrapper rejects them first). consts: the
// host's float64 constants (ops/seip.py::kernel_constants).

// table: (3 * n_steps, TimeLayout::kRow) float32, the time rows of step n's stage
// times float(n) * dt, + float(0.5 dt) and + float(dt). Returns cudaGetLastError().
extern "C" int dynode_seip_time_table(int A, int J, int K, int M, int L, int seasonal, int n_knots,
                                      const double* consts, double dt, int n_steps, float* table,
                                      void* stream) {
  if (!production(A, J, K, M, L, seasonal, n_knots) || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto c = read_consts<4, 4, 4, 4, 2>(consts, n_knots);
  const int n = 3 * n_steps * TimeLayout<4, 4, 2>::kRow;
  constexpr int kThreads = 256;
  seip_time_table_kernel<4, 4, 4, 4, 2, true><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                                 static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<float>(dt), static_cast<float>(0.5 * dt), n_steps, table);
  return static_cast<int>(cudaGetLastError());
}

// table: as written by dynode_seip_time_table for the same dt and n_steps; y0: the
// shared (S, E, I, C) flattened, float32; scales: (L, B) float32; out_*: the saved
// compartments or null, (n_saves, *compartment, B) in bf16 when bf16 != 0, in the tile
// layout when packed != 0. Returns cudaGetLastError() after the launch.
extern "C" int dynode_seip_rk4(int A, int J, int K, int M, int L, int seasonal, int n_knots,
                               const double* consts, const float* table, const float* y0,
                               const float* scales, void* out_s, void* out_e, void* out_i,
                               void* out_c, int bf16, int packed, int batch, double dt, int n_steps,
                               int save_stride, void* stream) {
  if (!production(A, J, K, M, L, seasonal, n_knots)) return static_cast<int>(cudaErrorInvalidValue);
  const Outs outs{{out_s, out_e, out_i, out_c}, bf16, packed};
  const auto c = read_consts<4, 4, 4, 4, 2>(consts, n_knots);
  return launch<4, 4, 4, 4, 2, true, kWidth>(c, table, y0, scales, outs, batch, dt, n_steps,
                                             save_stride, static_cast<cudaStream_t>(stream));
}
