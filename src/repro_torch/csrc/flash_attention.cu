// Blocked attention with the online softmax: O = softmax(Q K^T / sqrt(d) + mask) V.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _fa_kernel) and its GQA wrapper flash_attention_gqa.  Q [B, Sq, H, d],
// K/V [B, Skv, KV, d] given by element strides (d contiguous), float32 or
// bfloat16; causal (qpos >= kpos) and window (qpos - kpos < window) masks on
// absolute positions; float32 m, l and accumulator; output in Q's type.  A
// row with no valid key outputs exactly 0, as the contract
// (repro/kernels/ref.py::flash_attention_ref) says.  The Pallas kernel masks
// with a finite -1e30, so a row that is masked in every block gets
// exp(0) = 1 weights and outputs the mean of V instead; here m starts at
// -inf, masked scores are -inf, and a row whose running max is still -inf
// adds nothing, so l stays 0 and the row is written as 0.
//
// Each input type has one kernel:
//
// bfloat16 -- flash_attention_tc_kernel, on the tensor cores (wgmma).  One
// CTA per (128 query rows, batch x head), heaviest causal tiles first; three
// warpgroups.  The producer warpgroup (registers cut to PRODUCER_REGS by
// setmaxnreg) has one thread start TMA loads through csrc/hopper.cuh: Q's
// 128 rows once, then K and V tiles of BKV keys into a ring of STAGES slots
// guarded by full/empty mbarriers.  Everything lands as bf16 in the 128-byte
// swizzle; a head_dim-wide row is ceil(d / 64) sub-tiles of 64 columns (one
// TMA box each; columns past d are zero-filled).  Each consumer warpgroup
// (registers raised to CONSUMER_REGS) owns 64 query rows:
//   - S = Q K^T by wgmma m64n64k16, both operands K-major in shared memory,
//     S in registers as float32;
//   - the online softmax on S's register layout: a row lives in the 4 lanes
//     of a quad, so its max and sum take two shuffles; exp2 of prescaled
//     scores;
//   - O += P V by wgmma with P from registers (S's accumulator layout is
//     the A operand's) and V MN-major from shared memory (transpose bit).
//     P goes in as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi): P
//     rounded once to bf16 (as FlashAttention and SDPA do) is off by up to
//     2^-9 relative, which misses the bf16 tolerance where a row with few
//     keys cancels to a small output (tests/test_torch_lm_design.py), so
//     P V costs two wgmmas a k step -- 6 d FLOPs a pair, not 4 d;
//   - the stage goes back to the producer, one arrival a warp.
// Per consumer thread at d = 256: O 128 float registers, S 32, P 2 x 16 words.
// Shared memory at d = 256: Q 64 KB + K 2 x 32 KB + V 2 x 32 KB = 192 KB.
//
// float32 -- flash_attention_f32_kernel, on the CUDA cores: the tensor cores
// would take float32 only as TF32, which does not hold the float32 tolerance.
// One CUDA block per (q tile of 64 rows, batch x head); eight warps own eight
// query rows each.  Per kv tile of 32 keys (K and V staged in shared memory):
//   - scores: lane c computes the 8 rows' dot products with key c (Q rows
//     are shared-memory broadcasts, K rows padded by 4 floats so the 128-bit
//     loads of eight lanes hit disjoint banks);
//   - softmax: row max and row sum by warp shuffles, no shared memory;
//   - P V: lane j accumulates columns j, j+32, ... of its 8 rows, taking each
//     p from its key's lane by shuffle.
// Shared memory at d = 256: Q 64 KB + K 33 KB + V 32 KB = 129 KB.
//
// Both kernels read kv head h / (H / KV) in place (GQA never materialises
// repeated K/V), skip kv tiles wholly above the causal diagonal or before the
// window (the bf16 kernel also skips, per warpgroup, tiles that hold no
// unmasked pair of its rows) and raise the shared-memory limit with
// cudaFuncSetAttribute.
//
// Bound on the H100: operations at the model's sequence lengths -- 4*d
// FLOPs per unmasked (query, key) pair against Q + K + V + O bytes once;
// 989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s for float32.
//
// Shapes: d a multiple of 32 and at most 256; 16-byte aligned rows (the bf16
// kernel's TMA maps also need every stride a multiple of 16 bytes).  Sq and
// Skv need not be tile multiples (edges are zero-filled and masked).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int BQ = 128;             // query rows a CTA: two consumer warpgroups
constexpr int BKV = 64;             // keys a kv tile
constexpr int STAGES = 2;           // K/V ring slots
constexpr int TC_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int SUB = 64;             // head-dim columns a 128-byte sub-tile
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65,536

template <int D>
struct TcShape {
  static constexpr int NSUB = (D + SUB - 1) / SUB;          // sub-tiles a row
  static constexpr int DP = NSUB * SUB;                     // O's columns, padded
  static constexpr int Q_SUB = BQ * 128;                    // bytes a Q sub-tile
  static constexpr int KV_SUB = BKV * 128;                  // bytes a K/V sub-tile
  static constexpr int Q_BYTES = NSUB * Q_SUB;
  static constexpr int KV_BYTES = NSUB * KV_SUB;            // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // + 1024 bytes of slack to align the base to the swizzle's period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

// (x, y) -> two bf16x2 words whose sum is (x, y) to ~16 bits: hi = bf16(x, y)
// and lo = bf16 of what hi misses.  The lower column sits in the low half.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int64_t o_sb, int64_t o_ss,
                          int64_t o_sh, int H, int KVH, int Sq, int Skv, int causal,
                          int window, float scale_log2) {
  using S = TcShape<D>;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* base = tc_smem + ((1024u - (hopper::smem_u32(tc_smem) & 1023u)) & 1023u);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + S::Q_BYTES;
  uint8_t* Vs = Ks + STAGES * S::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * S::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest (causal) tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  // kv tiles that can hold a valid key for some row of this CTA
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, min(q0 + BQ, Sq));
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / BKV, t_hi = (k_hi + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);          // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_arrive_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::NSUB; ++c)
        hopper::tma_load_4d(Qs + c * S::Q_SUB, &tq, q_full, c * SUB, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        hopper::mbar_wait(&empty[stage], phase ^ 1u);
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * S::KV_BYTES);
        uint8_t* kd = Ks + stage * S::KV_BYTES;
        uint8_t* vd = Vs + stage * S::KV_BYTES;
#pragma unroll
        for (int c = 0; c < S::NSUB; ++c) {
          hopper::tma_load_4d(kd + c * S::KV_SUB, &tk, &full[stage], c * SUB, t * BKV, kvh, b);
          hopper::tma_load_4d(vd + c * S::KV_SUB, &tv, &full[stage], c * SUB, t * BKV, kvh, b);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;                         // consumer warpgroup 0 or 1
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid % 32;
    const int qa = q0 + 64 * cw;                   // the warpgroup's first row
    const int qb = min(qa + 64, Sq) - 1;           // its last (qb < qa: none)
    const int row0 = qa + 16 * (tid / 32) + lane / 4, row1 = row0 + 8;
    const int c2 = 2 * (lane % 4);

    float acc[S::DP / 2];
#pragma unroll
    for (int i = 0; i < S::DP / 2; ++i) acc[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    const uint32_t q_addr = hopper::smem_u32(Qs) + cw * 64 * 128;
    const uint32_t k_addr = hopper::smem_u32(Ks), v_addr = hopper::smem_u32(Vs);
    hopper::mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      const int k0 = t * BKV;
      const int k_last = min(k0 + BKV, Skv) - 1;
      // does this tile hold an unmasked pair of the warpgroup's rows?
      const bool live = qa <= qb && (!causal || k0 <= qb) &&
                        (window <= 0 || k_last >= qa - window + 1);
      hopper::mbar_wait(&full[stage], phase);
      if (live) {
        float s[BKV / 2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
        const uint32_t ks = k_addr + stage * S::KV_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 bf16 = 32 bytes into the 128-byte row
          const uint64_t da = hopper::smem_desc(q_addr + (kk / 4) * S::Q_SUB + off, 16, 1024);
          const uint64_t db = hopper::smem_desc(ks + (kk / 4) * S::KV_SUB + off, 16, 1024);
          hopper::Wgmma<BKV, 0>::ss(s, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        // scores in the log2 domain; masked pairs -inf
        const bool unmasked = k0 + BKV <= Skv && (!causal || k0 + BKV - 1 <= qa) &&
                              (window <= 0 || qb - k0 < window);
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (!unmasked) {
              const int key = k0 + 8 * j + c2 + (e & 1);
              const int q = e < 2 ? row0 : row1;
              bool ok = key < Skv;
              if (causal) ok = ok && q >= key;
              if (window > 0) ok = ok && q - key < window;
              if (!ok) x = -CUDART_INF_F;
            }
            s[4 * j + e] = x;
          }
        }
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // a row with no valid key yet keeps p = 0 (exp2(-inf - 0)), l = 0
        const float base0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
        const float base1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
        const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
        m0 = mn0;
        m1 = mn1;
        uint32_t ph[BKV / 16][4], pl[BKV / 16][4];   // P = hi + lo, as A fragments
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          const float p0 = exp2f(s[4 * j] - base0), p1 = exp2f(s[4 * j + 1] - base0);
          const float p2 = exp2f(s[4 * j + 2] - base1), p3 = exp2f(s[4 * j + 3] - base1);
          ps0 += p0 + p1;
          ps1 += p2 + p3;
          // keys 8j..8j+7 are half j % 2 of k step j / 2: A's a[0|2] (row0), a[1|3] (row1)
          const int a = 2 * (j % 2);
          split_bf16(p0, p1, ph[j / 2][a], pl[j / 2][a]);
          split_bf16(p2, p3, ph[j / 2][a + 1], pl[j / 2][a + 1]);
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
#pragma unroll
        for (int j = 0; j < S::DP / 8; ++j) {
          acc[4 * j] *= alpha0;
          acc[4 * j + 1] *= alpha0;
          acc[4 * j + 2] *= alpha1;
          acc[4 * j + 3] *= alpha1;
        }

        // O += P_hi V + P_lo V: V MN-major, sub-tiles of 64 columns KV_SUB
        // bytes apart
        const uint32_t vs = v_addr + stage * S::KV_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t db = hopper::smem_desc(vs + kk * 16 * 128, S::KV_SUB, 1024);
          hopper::Wgmma<S::DP, 1>::rs(acc, ph[kk], db);
          hopper::Wgmma<S::DP, 1>::rs(acc, pl[kk], db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) { stage = 0; phase ^= 1u; }
    }

    // the row sums are spread over the quad's 4 lanes
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int j = 0; j < S::DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= D) continue;
      if (row0 <= qb)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + col) = __floats2bfloat162_rn(
            l0 > 0.f ? acc[4 * j] * inv0 : 0.f, l0 > 0.f ? acc[4 * j + 1] * inv0 : 0.f);
      if (row1 <= qb)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_ss + col) = __floats2bfloat162_rn(
            l1 > 0.f ? acc[4 * j + 2] * inv1 : 0.f, l1 > 0.f ? acc[4 * j + 3] * inv1 : 0.f);
    }
  }
}

// Tensor maps of Q and of K/V as 4-d tensors {d, S, heads, B} (innermost
// first), boxes of 64 columns x `rows` rows, 128-byte swizzle; then the launch.
template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, const int64_t* st,
              int B, int H, int KVH, int Sq, int Skv, int causal, int window,
              float scale, cudaStream_t s) {
  using S = TcShape<D>;
  CUtensorMap tq, tk, tv;
  const uint64_t qdim[4] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)H, (uint64_t)B};
  const uint64_t qstr[3] = {(uint64_t)st[1] * 2, (uint64_t)st[2] * 2, (uint64_t)st[0] * 2};
  const uint32_t qbox[4] = {SUB, BQ, 1, 1};
  const uint64_t kdim[4] = {(uint64_t)D, (uint64_t)Skv, (uint64_t)KVH, (uint64_t)B};
  const uint64_t kstr[3] = {(uint64_t)st[4] * 2, (uint64_t)st[5] * 2, (uint64_t)st[3] * 2};
  const uint32_t kbox[4] = {SUB, BKV, 1, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUresult r = hopper::encode_map(&tq, bf, 4, q, qdim, qstr, qbox, sw);
  if (r == CUDA_SUCCESS) r = hopper::encode_map(&tk, bf, 4, k, kdim, kstr, kbox, sw);
  if (r == CUDA_SUCCESS) r = hopper::encode_map(&tv, bf, 4, v, kdim, kstr, kbox, sw);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  auto fn = flash_attention_tc_kernel<D>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fn<<<grid, TC_THREADS, S::SMEM, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[0],
                                       st[1], st[2], H, KVH, Sq, Skv, causal, window,
                                       scale * 1.4426950408889634f);  // log2(e)
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;
constexpr int F32_BKV = 32;
constexpr int F32_WARPS = 8;
constexpr int F32_ROWS = F32_BQ / F32_WARPS;     // query rows per warp
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int MAX_DJ = 8;            // d / 32 <= 8

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// rows x d tile of a [.., S, heads, d] tensor into shared memory as float
// (row pitch `pitch`); rows at or past `s_len` are zero-filled.
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src,
                                      int64_t row_stride, int row0, int rows,
                                      int s_len, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += F32_THREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    float v[8];
    if (row0 + r < s_len) {
      load8(src + (int64_t)(row0 + r) * row_stride + c, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    float* out = dst + r * pitch + c;
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(out + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                           int H, int KVH, int Sq, int Skv, int d,
                           int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kpitch = d + 4;
  float* Qs = smem;                         // [F32_BQ][d]
  float* Ks = Qs + F32_BQ * d;                  // [F32_BKV][d + 4]
  float* Vs = Ks + F32_BKV * kpitch;            // [F32_BKV][d]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;     // heaviest (causal) tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * F32_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dj = d / 32;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * kv_sb + kvh * kv_sh;
  const float* vb = v + b * kv_sb + kvh * kv_sh;
  stage(Qs, d, qb, q_ss, q0, F32_BQ, Sq, d);

  // kv tiles that can hold a valid key for some row of this q tile
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, q0 + F32_BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / F32_BKV, t_hi = (k_hi + F32_BKV - 1) / F32_BKV;

  float m[F32_ROWS], l[F32_ROWS], acc[F32_ROWS][MAX_DJ];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[r][j] = 0.f;
  }
  const float* qrow = Qs + warp * F32_ROWS * d;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * F32_BKV;
    __syncthreads();                        // previous tile fully consumed
    stage(Ks, kpitch, kb, kv_ss, k0, F32_BKV, Skv, d);
    stage(Vs, d, vb, kv_ss, k0, F32_BKV, Skv, d);
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * kpitch;
    for (int c = 0; c < d; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + r * d + c);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float p[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      const int qpos = q0 + warp * F32_ROWS + r;
      bool valid = kpos < Skv;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && (qpos - kpos < window);
      const float sc = valid ? s[r] * scale : -CUDART_INF_F;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f;
      p[r] = 0.f;
      if (m_new != -CUDART_INF_F) {         // else: no valid key yet, nothing to add
        p[r] = valid ? expf(sc - m_new) : 0.f;
        alpha = expf(m[r] - m_new);         // exp(-inf) = 0 on the first valid tile
      }
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < MAX_DJ; ++j) acc[r][j] *= alpha;
    }

    // acc += P V
    for (int c = 0; c < F32_BKV; ++c) {
      float pc[F32_ROWS];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) pc[r] = __shfl_sync(0xffffffffu, p[r], c);
      const float* vrow = Vs + c * d + lane;
#pragma unroll
      for (int j = 0; j < MAX_DJ; ++j) {
        if (j < dj) {
          const float vv = vrow[j * 32];
#pragma unroll
          for (int r = 0; r < F32_ROWS; ++r) acc[r][j] = fmaf(pc[r], vv, acc[r][j]);
        }
      }
    }
  }

  float* ob = o + b * q_sb + h * q_sh;
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const int qpos = q0 + warp * F32_ROWS + r;
    if (qpos >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    float* orow = ob + (int64_t)qpos * q_ss + lane;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j)
      if (j < dj) orow[j * 32] = l[r] > 0.f ? acc[r][j] * inv : 0.f;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               const int64_t* strides, int B, int H, int KVH, int Sq, int Skv, int d,
               int causal, int window, float scale, cudaStream_t s) {
  auto fn = flash_attention_f32_kernel;
  const int smem = (F32_BQ * d + F32_BKV * (d + 4) + F32_BKV * d) * (int)sizeof(float);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, B * H);
  fn<<<grid, F32_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], H, KVH, Sq, Skv, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: {q batch, q seq, q head, kv batch, kv seq, kv head} in elements
// (O has Q's layout).  is_bf16: 0 = float32 (CUDA-core kernel), 1 = bfloat16
// (tensor-core kernel).  Returns 0 once launched, cudaGetLastError() (> 0)
// if the launch failed, or -CUresult (< 0) if cuTensorMapEncodeTiled refused a map.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const int64_t* strides, int B, int H, int KVH, int Sq,
                           int Skv, int d, int causal, int window, float scale,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                         // clear any stale error
  if (d % 32 != 0 || d > 32 * MAX_DJ || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16)
    return launch_f32(q, k, v, o, strides, B, H, KVH, Sq, Skv, d, causal, window,
                      scale, s);
  switch (d) {
#define FLASH_TC_CASE(D)                                                        \
    case D:                                                                     \
      return launch_tc<D>(q, k, v, o, strides, B, H, KVH, Sq, Skv, causal,      \
                          window, scale, s);
    FLASH_TC_CASE(32) FLASH_TC_CASE(64) FLASH_TC_CASE(96) FLASH_TC_CASE(128)
    FLASH_TC_CASE(160) FLASH_TC_CASE(192) FLASH_TC_CASE(224) FLASH_TC_CASE(256)
#undef FLASH_TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int status) {
  if (status < 0) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = -status)";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
