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
// Grid: one CUDA block per (q tile of 64 rows, batch x head); heaviest causal
// tiles first.  The block reads its K/V head h / (H / KV) in place, so GQA
// never materialises the repeated K/V.  Eight warps own eight query rows
// each.  Per kv tile of 32 keys (K and V staged in shared memory as float):
//   - scores: lane c computes the 8 rows' dot products with key c (Q rows
//     are shared-memory broadcasts, K rows padded by 4 floats so the 128-bit
//     loads of eight lanes hit disjoint banks);
//   - softmax: row max and row sum by warp shuffles, no shared memory;
//   - P V: lane j accumulates columns j, j+32, ... of its 8 rows, taking each
//     p from its key's lane by shuffle.
// Kv tiles wholly above the causal diagonal or before the window are skipped.
// Shared memory at d = 256: Q 64 KB + K 33 KB + V 32 KB = 129 KB, above the
// 48 KB default, so the launch raises the limit with cudaFuncSetAttribute.
//
// Bound on the H100: operations at the model's sequence lengths -- 4*d
// FLOPs per unmasked (query, key) pair against Q + K + V + O bytes once.
// This first kernel runs on the float32 CUDA cores (67 TFLOP/s) in both
// input types; the bf16 tensor cores (989 TFLOP/s, wgmma) are later work.
//
// Shapes: d a multiple of 32 and at most 256; 16-byte aligned rows.  Sq and
// Skv need not be tile multiples (edges are zero-filled and masked).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 32;
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DJ = 8;            // d / 32 <= 8

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// rows x d tile of a [.., S, heads, d] tensor into shared memory as float
// (row pitch `pitch`); rows at or past `s_len` are zero-filled.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int64_t row_stride, int row0, int rows,
                                      int s_len, int d) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                       int H, int KVH, int Sq, int Skv, int d,
                       int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kpitch = d + 4;
  float* Qs = smem;                         // [BQ][d]
  float* Ks = Qs + BQ * d;                  // [BKV][d + 4]
  float* Vs = Ks + BKV * kpitch;            // [BKV][d]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;     // heaviest (causal) tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dj = d / 32;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * kv_sb + kvh * kv_sh;
  const T* vb = v + b * kv_sb + kvh * kv_sh;
  stage(Qs, d, qb, q_ss, q0, BQ, Sq, d);

  // kv tiles that can hold a valid key for some row of this q tile
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / BKV, t_hi = (k_hi + BKV - 1) / BKV;

  float m[ROWS], l[ROWS], acc[ROWS][MAX_DJ];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) acc[r][j] = 0.f;
  }
  const float* qrow = Qs + warp * ROWS * d;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();                        // previous tile fully consumed
    stage(Ks, kpitch, kb, kv_ss, k0, BKV, Skv, d);
    stage(Vs, d, vb, kv_ss, k0, BKV, Skv, d);
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * kpitch;
    for (int c = 0; c < d; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + r * d + c);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
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
    for (int c = 0; c < BKV; ++c) {
      float pc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pc[r] = __shfl_sync(0xffffffffu, p[r], c);
      const float* vrow = Vs + c * d + lane;
#pragma unroll
      for (int j = 0; j < MAX_DJ; ++j) {
        if (j < dj) {
          const float vv = vrow[j * 32];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(pc[r], vv, acc[r][j]);
        }
      }
    }
  }

  T* ob = o + b * q_sb + h * q_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = ob + (int64_t)qpos * q_ss + lane;
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j)
      if (j < dj) store(orow + j * 32, l[r] > 0.f ? acc[r][j] * inv : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int B, int H, int KVH, int Sq, int Skv, int d,
           int causal, int window, float scale, cudaStream_t s) {
  auto fn = flash_attention_kernel<T>;
  const int smem = (BQ * d + BKV * (d + 4) + BKV * d) * (int)sizeof(float);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fn<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], H, KVH, Sq, Skv, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: {q batch, q seq, q head, kv batch, kv seq, kv head} in elements
// (O has Q's layout).  is_bf16: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const int64_t* strides, int B, int H, int KVH, int Sq,
                           int Skv, int d, int causal, int window, float scale,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                         // clear any stale error
  if (d % 32 != 0 || d > 32 * MAX_DJ || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, strides, B, H, KVH, Sq, Skv, d,
                                 causal, window, scale, s);
  return launch<float>(q, k, v, o, strides, B, H, KVH, Sq, Skv, d, causal,
                       window, scale, s);
}

const char* flash_attention_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
