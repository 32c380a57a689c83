// Reduced-precision serving matmul: out = (A @ W_q) * scale[None, :].
//
// Replaces the TPU kernel src/repro/kernels/fixed_matmul.py::quantized_matmul_pallas
// (body _mm_kernel): activations A [M, K] in float32 or bfloat16, int8
// per-output-channel weights W_q [K, N], float32 scales [N], float32 output
// [M, N], float32 accumulation, the scale applied once in the epilogue.  The
// Pallas grid carried the accumulator in VMEM scratch across its sequential
// k axis; here the k loop runs inside a CTA and the accumulator lives in
// registers.
//
// Both kernels cover the output in BM x BN tiles and split K in a fixed
// order: grid (N tiles, M tiles, splits), split z takes the k steps
// [z * steps / splits, (z + 1) * steps / splits) (kernels/fixed_matmul.py
// plans `splits` from the CTAs the card runs at once, which
// quantized_matmul_resident reports, so that narrow N still fills the
// SMs).  With one split a CTA writes its tile; otherwise it writes its raw
// sums to the float32 workspace [splits, M, N], and the last CTA of the
// tile to arrive (a ticket per tile that wraps back to 0, so nothing is
// cleared between calls) folds the partials in split order and applies the
// scale -- the same bits every call.
//
// bfloat16 A -- quantized_matmul_tc_kernel, on the tensor cores (wgmma).
// The producer warpgroup has one thread start TMA loads through
// csrc/hopper.cuh into a ring of TC_STAGES slots guarded by full/empty
// mbarriers: A's 128 x 64 tile and W's 64 x 128 int8 tile, both in the
// 128-byte swizzle (TMA strides must be multiples of 16 bytes, so when
// N % 16 != 0 the producer warp copies W's tile with 8-byte loads, into the
// same swizzle).  The consumer warpgroups compute the tile transposed,
// out^T = W^T A^T, so that the int8 operand is wgmma's A, which may come
// from registers: each thread reads its W bytes from shared memory, widens
// them to bf16 in registers and hands them to m64n128k16 wgmmas whose B is
// A's tile, K-major in shared memory.  Nothing widened goes back to shared
// memory, and the two warpgroups (64 columns of W each) wait for each other
// only at a split's fold.  A warpgroup's 64 "rows" are W's columns in the
// order that puts a thread's two rows, r and r + 8, on adjacent columns: it
// reads two-byte pairs and stores float2 pairs of out.  int8 -> bf16 is
// exact and a bf16 x bf16 product is exact in float32, so the kernel sums
// the plain version's products; only the order of the sum differs.  64
// float32 accumulators a thread.  (Widening W into a shared bf16 tile that
// both warpgroups' wgmmas read instead was bound by shared memory's
// bandwidth.)
//
// float32 A -- quantized_matmul_f32_kernel, on the CUDA cores (no tensor-core
// type keeps float32 activations' products exact).  256 threads, each owning
// an 8 x 8 register tile (rows ty*4+{0..3} and 64+ty*4+{0..3}, the same for
// columns, so the shared-memory reads are broadcasts or conflict-free); per
// k step of 16 it stages A's 128 x 16 slice as float (transposed) and W's
// 16 x 128 slice as int8 bytes, then each thread does 64 FMAs.
//
// Bound on the H100: at prefill sizes (M = 4096) operations -- 2*M*K*N over
// 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (float32 CUDA cores).  At
// decode-like sizes (M = 128) the weight bytes for bf16: W streams as int8,
// one byte a weight, a quarter of the float32 bytes.  The K split lets
// w_down (N = 2048: 16 column tiles) at M = 128 use every SM.
//
// Shapes: K % 8 == 0 and N % 8 == 0 (16-byte rows of A, 8-byte column
// groups); M, N and K need not be tile multiples (edges are zero-filled and
// masked).
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;            // output tile rows, both kernels
constexpr int BN = 128;            // output tile columns, both kernels
constexpr int BK = 16;             // k step of the float32 kernel
constexpr int THREADS = 256;       // float32 kernel
constexpr int TC_BK = 64;          // k step of the bf16 kernel: a 128-byte row of A
constexpr int TC_STAGES = 4;       // A/W ring slots
constexpr int TC_THREADS = 384;    // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_BAR = 1;    // named barrier of the 256 consumer threads

constexpr int A_BYTES = BM * TC_BK * 2;     // A tile, bf16, 128-byte rows
constexpr int W_BYTES = TC_BK * BN;         // W tile, int8, 128-byte rows
constexpr int TC_SMEM = 1024 + TC_STAGES * (A_BYTES + W_BYTES) + 8 * 2 * TC_STAGES;

// First k step of split z of `splits` over `steps` (kernels/fixed_matmul.py
// plans with the same formula).
__device__ __forceinline__ int split_begin(int z, int splits, int steps) {
  return static_cast<int>(static_cast<int64_t>(z) * steps / splits);
}

// True in the last of n CTAs to arrive; it then sees every global write the
// others made before the call.  The ticket wraps back to 0.  Called by the
// `count` threads that wrote (named barrier `bar`; 0 with every thread of
// the CTA is __syncthreads); `leader` is one of them.  As in a cooperative
// grid sync, the barrier orders the threads' writes before the leader's
// fence and atomic.
__device__ __forceinline__ bool last_cta(unsigned int* ticket, unsigned int n, uint32_t bar,
                                         uint32_t count, bool leader) {
  __shared__ int s_last;
  hopper::named_barrier(bar, count);
  if (leader) {
    __threadfence();
    s_last = atomicInc(ticket, n - 1) == n - 1;
    if (s_last) __threadfence();
  }
  hopper::named_barrier(bar, count);
  return s_last != 0;
}

// out tile (m0, n0) = scale * (ws[0] + ws[1] + ... + ws[splits - 1]), summed
// in that order; float4 columns (N % 8 == 0 keeps groups of 4 whole).
__device__ void fold_splits(const float* ws, const float* __restrict__ scale,
                            float* __restrict__ out, int M, int N, int m0, int n0,
                            int splits, int tid, int nthreads) {
  const int64_t plane = static_cast<int64_t>(M) * N;
  for (int e = tid; e < BM * BN / 4; e += nthreads) {
    const int m = m0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
    if (m >= M || n >= N) continue;
    const float* p = ws + static_cast<int64_t>(m) * N + n;
    float4 acc = __ldcg(reinterpret_cast<const float4*>(p));
    for (int z = 1; z < splits; ++z) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p + z * plane));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(m) * N + n) =
        make_float4(acc.x * sc.x, acc.y * sc.y, acc.z * sc.z, acc.w * sc.w);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
// Four int8 -> two bf16x2, exactly: x ^ 0x80 turns each byte b into b + 128,
// placed in a float as 2^23 + b + 128; subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ uint2 widen4(uint32_t x) {
  x ^= 0x80808080u;
  const float off = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - off;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - off;
  const float f2 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - off;
  const float f3 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - off;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f2, f3);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// Offset of byte (k, n) in a staged W tile: row k at k * 128, its 16-byte
// chunk j at chunk j ^ (k % 8) (the 128-byte swizzle).
__device__ __forceinline__ int w_offset(int k, int n) {
  return k * 128 + ((((n >> 4) ^ (k & 7)) << 4) | (n & 15));
}

// The A fragment of one k16 step for the rows of W's columns n and n + 1
// (n even): a[0] = (k, k+1) of column n, a[1] of column n + 1, a[2], a[3]
// the same at k + 8, in bf16, with k = 2 (lane % 4) the step's first k.
__device__ __forceinline__ void w_fragment(const uint8_t* wt, int k, int n, uint32_t (&a)[4]) {
  const uint32_t x0 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k, n));
  const uint32_t x1 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 1, n));
  const uint32_t x2 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 8, n));
  const uint32_t x3 = *reinterpret_cast<const uint16_t*>(wt + w_offset(k + 9, n));
  // bytes (k, n), (k+1, n), (k, n+1), (k+1, n+1)
  const uint2 lo = widen4(__byte_perm(x0, x1, 0x5140));
  const uint2 hi = widen4(__byte_perm(x2, x3, 0x5140));
  a[0] = lo.x;
  a[1] = lo.y;
  a[2] = hi.x;
  a[3] = hi.y;
}

__global__ void __launch_bounds__(TC_THREADS, 1)
quantized_matmul_tc_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tw,
                           const int8_t* __restrict__ w, int w_ragged,
                           const float* __restrict__ scale, float* __restrict__ out,
                           float* __restrict__ ws, unsigned int* __restrict__ tickets,
                           int M, int N, int K, int splits) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* base = tc_smem + ((1024u - (hopper::smem_u32(tc_smem) & 1023u)) & 1023u);
  uint8_t* As = base;
  uint8_t* Ws = As + TC_STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + TC_STAGES * W_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int steps = (K + TC_BK - 1) / TC_BK;
  const int s0 = split_begin(z, splits, steps);
  const int n_steps = split_begin(z + 1, splits, steps) - s0;   // >= 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      // the TMA thread's arrival, and the producer warp's when it copies W
      hopper::mbar_init(&full[s], w_ragged ? 33 : 1);
      hopper::mbar_init(&empty[s], 8);          // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warp: lane 0 starts the TMA loads; when W's rows are not
    // 16-byte multiples (no TMA map takes them) all 32 lanes copy W's tile
    // with 8-byte loads and arrive
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::tma_prefetch(&ta);
        if (!w_ragged) hopper::tma_prefetch(&tw);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_steps; ++i) {
        const int k0 = (s0 + i) * TC_BK;
        uint8_t* wd = Ws + stage * W_BYTES;
        hopper::mbar_wait(&empty[stage], phase ^ 1u);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[stage], A_BYTES + (w_ragged ? 0 : W_BYTES));
          hopper::tma_load_2d(As + stage * A_BYTES, &ta, &full[stage], k0, m0);
          if (!w_ragged) hopper::tma_load_2d(wd, &tw, &full[stage], n0, k0);
        }
        if (w_ragged) {
          for (int c = lane; c < TC_BK * BN / 8; c += 32) {
            const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
            const int k = k0 + r, n = n0 + col;
            uint2 v = make_uint2(0u, 0u);
            if (k < K && n < N)
              v = __ldg(reinterpret_cast<const uint2*>(w + static_cast<int64_t>(k) * N + n));
            *reinterpret_cast<uint2*>(wd + w_offset(r, col)) = v;
          }
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == TC_STAGES) { stage = 0; phase ^= 1u; }
      }
    }
    return;
  }

  const int cw = wg - 1;                          // consumer warpgroup 0 or 1
  const int tid = threadIdx.x - 128;              // 0..255 over both
  const int lane = tid % 32;
  // this thread's rows r and r + 8 are W's columns n_loc and n_loc + 1
  const int n_loc = 64 * cw + 16 * ((tid % 128) / 32) + 2 * (lane / 4);
  const int c2 = 2 * (lane % 4);
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  const uint32_t a_addr = hopper::smem_u32(As);

  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_steps; ++i) {
    hopper::mbar_wait(&full[stage], phase);
    const uint8_t* wt = Ws + stage * W_BYTES;
    uint32_t frag[TC_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {   // widen step kk + 1 while kk runs
      w_fragment(wt, 16 * kk + c2, n_loc, frag[kk]);
      const uint64_t db = hopper::smem_desc(a_addr + stage * A_BYTES + kk * 32, 16, 1024);
      hopper::wgmma_fence();
      hopper::Wgmma<BM, 0>::rs(acc, frag[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == TC_STAGES) { stage = 0; phase ^= 1u; }
  }

  // accumulators: rows (W's columns n, n + 1) x columns 8 j + c2 (+1) of A's
  // rows; out[m][n..n+1] takes (acc[4j], acc[4j+2]), out[m+1][..] (acc[4j+1], acc[4j+3])
  const int n = n0 + n_loc;
  const bool direct = splits == 1;
  float* dst = direct ? out : ws + static_cast<int64_t>(z) * M * N;
  if (n < N) {
    const float2 sc = direct ? *reinterpret_cast<const float2*>(scale + n) : make_float2(1.f, 1.f);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = m0 + 8 * j + c2;
      if (m < M)
        *reinterpret_cast<float2*>(dst + static_cast<int64_t>(m) * N + n) =
            make_float2(acc[4 * j] * sc.x, acc[4 * j + 2] * sc.y);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(dst + static_cast<int64_t>(m + 1) * N + n) =
            make_float2(acc[4 * j + 1] * sc.x, acc[4 * j + 3] * sc.y);
    }
  }
  if (direct) return;
  if (last_cta(&tickets[blockIdx.y * gridDim.x + blockIdx.x], splits, CONSUMER_BAR, 256,
               tid == 0))
    fold_splits(ws, scale, out, M, N, m0, n0, splits, tid, 256);
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(THREADS)
quantized_matmul_f32_kernel(const float* __restrict__ a, const int8_t* __restrict__ w,
                            const float* __restrict__ scale, float* __restrict__ out,
                            float* __restrict__ ws, unsigned int* __restrict__ tickets,
                            int M, int N, int K, int splits) {
  __shared__ __align__(16) float As[BK][BM];     // A slice, k-major
  __shared__ __align__(16) int8_t Ws[BK][BN];    // W slice, int8 bytes

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int steps = (K + BK - 1) / BK;
  const int k_begin = split_begin(z, splits, steps) * BK;
  const int k_end = min(split_begin(z + 1, splits, steps) * BK, K);
  // loaders: A row tid/2, 8 k's at (tid%2)*8; W row tid/16, 8 n's at (tid%16)*8
  const int a_row = tid / 2, a_k = (tid % 2) * 8;
  const int w_row = tid / 16, w_n = (tid % 16) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    float av[8];
    const int gm = m0 + a_row, gk = k0 + a_k;
    if (gm < M && gk < K) {
      load8(a + (int64_t)gm * K + gk, av);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = 0.f;
    }
    uint2 wv = make_uint2(0u, 0u);
    const int wk = k0 + w_row, wn = n0 + w_n;
    if (wk < K && wn < N) wv = *reinterpret_cast<const uint2*>(w + (int64_t)wk * N + wn);
#pragma unroll
    for (int i = 0; i < 8; ++i) As[a_k + i][a_row] = av[i];
    *reinterpret_cast<uint2*>(&Ws[w_row][w_n]) = wv;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const char4 w_lo = *reinterpret_cast<const char4*>(&Ws[k][tx * 4]);
      const char4 w_hi = *reinterpret_cast<const char4*>(&Ws[k][64 + tx * 4]);
      const float ar[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float wr[8] = {(float)w_lo.x, (float)w_lo.y, (float)w_lo.z, (float)w_lo.w,
                           (float)w_hi.x, (float)w_hi.y, (float)w_hi.z, (float)w_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: per-column scale (or raw sums into the workspace), float4
  // stores (N % 8 == 0 keeps 4-column groups whole)
  const bool direct = splits == 1;
  float* dst = direct ? out : ws + static_cast<int64_t>(z) * M * N;
#pragma unroll
  for (int hj = 0; hj < 2; ++hj) {
    const int n = n0 + hj * 64 + tx * 4;
    if (n >= N) continue;
    const float4 sc = direct ? *reinterpret_cast<const float4*>(scale + n)
                             : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
      if (m >= M) continue;
      float4 o;
      o.x = acc[i][hj * 4 + 0] * sc.x;
      o.y = acc[i][hj * 4 + 1] * sc.y;
      o.z = acc[i][hj * 4 + 2] * sc.z;
      o.w = acc[i][hj * 4 + 3] * sc.w;
      *reinterpret_cast<float4*>(dst + (int64_t)m * N + n) = o;
    }
  }
  if (direct) return;
  if (last_cta(&tickets[blockIdx.y * gridDim.x + blockIdx.x], splits, 0, THREADS, tid == 0))
    fold_splits(ws, scale, out, M, N, m0, n0, splits, tid, THREADS);
}

// Tensor maps of A ({K, M}, 64 x 128 boxes) and, when N % 16 == 0, of W
// ({N, K}, 128 x 64 boxes), both in the 128-byte swizzle; then the launch.
int launch_tc(const void* a, const void* w, const void* scale, void* out, void* ws,
              void* tickets, int M, int N, int K, int splits, cudaStream_t s) {
  CUtensorMap ta, tw;
  const uint64_t adim[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t astr[1] = {(uint64_t)K * 2};
  const uint32_t abox[2] = {TC_BK, BM};
  CUresult r = hopper::encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, adim, astr,
                                  abox, CU_TENSOR_MAP_SWIZZLE_128B);
  const int w_ragged = N % 16 != 0;
  memset(&tw, 0, sizeof(tw));              // unused when w_ragged
  if (r == CUDA_SUCCESS && !w_ragged) {
    const uint64_t wdim[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t wstr[1] = {(uint64_t)N};
    const uint32_t wbox[2] = {BN, TC_BK};
    r = hopper::encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdim, wstr, wbox,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaFuncSetAttribute(quantized_matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TC_SMEM);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quantized_matmul_tc_kernel<<<grid, TC_THREADS, TC_SMEM, s>>>(
      ta, tw, static_cast<const int8_t*>(w), w_ragged, static_cast<const float*>(scale),
      static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<unsigned int*>(tickets), M, N, K, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a_bf16: 0 = float32 activations (CUDA-core kernel), 1 = bfloat16
// (tensor-core kernel).  splits: the K split (1 = none); with splits > 1, ws
// holds splits * M * N floats and tickets one zeroed word per output tile
// (left zeroed).  Returns 0 once launched, cudaGetLastError() (> 0) if the
// launch failed, or -CUresult (< 0) if cuTensorMapEncodeTiled refused a map.
int quantized_matmul_launch(const void* a, const void* w, const void* scale, void* out,
                            void* ws, void* tickets, int M, int N, int K, int splits,
                            int a_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                          // clear any stale error
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a_bf16) return launch_tc(a, w, scale, out, ws, tickets, M, N, K, splits, s);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quantized_matmul_f32_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<unsigned int*>(tickets), M, N, K, splits);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of the a_bf16 kernel that one SM of the current device holds at
// once (> 0), or -cudaError_t if the runtime cannot say.
int quantized_matmul_resident(int a_bf16) {
  int n = 0;
  cudaError_t e;
  if (a_bf16) {
    e = cudaFuncSetAttribute(quantized_matmul_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, quantized_matmul_tc_kernel,
                                                        TC_THREADS, TC_SMEM);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, quantized_matmul_f32_kernel,
                                                      THREADS, 0);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

const char* quantized_matmul_error_string(int status) {
  if (status < 0) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = -status)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
