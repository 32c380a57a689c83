// Reduced-precision serving matmul: out = (A @ W_q) * scale[None, :].
//
// Replaces the TPU kernel src/repro/kernels/fixed_matmul.py::quantized_matmul_pallas
// (body _mm_kernel): activations A [M, K] in float32 or bfloat16, int8
// per-output-channel weights W_q [K, N], float32 scales [N], float32 output
// [M, N], float32 accumulation, the scale applied once in the epilogue.
//
// Grid: one CUDA block per 128 x 128 output tile; 256 threads, each owning
// an 8 x 8 register tile (rows ty*4+{0..3} and 64+ty*4+{0..3}, the same for
// columns, so the shared-memory reads are broadcasts or conflict-free).  The
// block walks K in steps of 16: it stages A's 128 x 16 slice in shared memory
// as float (transposed, bf16 widened on load) and W's 16 x 128 slice as int8
// bytes, then each thread does 64 FMAs per k step.  The Pallas grid carried
// the accumulator in VMEM scratch across its sequential k axis; here the
// k loop runs inside the block and the accumulator lives in registers.
//
// Bound on the H100: at prefill sizes (M = 4096) operations -- 2*M*K*N over
// the 67 TFLOP/s float32 rate of the CUDA cores (the kernel runs on them in
// both input types; 989 TFLOP/s is the bf16 tensor-core rate it does not
// use).  At decode-like sizes (M = 128) bytes of W dominate: W streams as
// int8, one byte a weight, a quarter of the float32 weight bytes, converted
// to float in registers.  A wgmma/TMA pipeline, and a split of K for the
// narrow-N case (w_down: N = 2048 gives 16 column tiles, so M = 128 fills 16
// of 132 SMs), are later work.
//
// Shapes: K % 8 == 0 and N % 8 == 0 (16-byte and 8-byte vector loads); M, N
// and K need not be tile multiples (edges are zero-filled and masked).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;

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

template <typename TA>
__global__ void __launch_bounds__(THREADS)
quantized_matmul_kernel(const TA* __restrict__ a, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, float* __restrict__ out,
                        int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM];     // A slice, k-major
  __shared__ __align__(16) int8_t Ws[BK][BN];    // W slice, int8 bytes

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loaders: A row tid/2, 8 k's at (tid%2)*8; W row tid/16, 8 n's at (tid%16)*8
  const int a_row = tid / 2, a_k = (tid % 2) * 8;
  const int w_row = tid / 16, w_n = (tid % 16) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
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

  // epilogue: per-column scale, float4 stores (N % 8 == 0 keeps 4-column
  // groups whole)
#pragma unroll
  for (int hj = 0; hj < 2; ++hj) {
    const int n = n0 + hj * 64 + tx * 4;
    if (n >= N) continue;
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
      if (m >= M) continue;
      float4 o;
      o.x = acc[i][hj * 4 + 0] * sc.x;
      o.y = acc[i][hj * 4 + 1] * sc.y;
      o.z = acc[i][hj * 4 + 2] * sc.z;
      o.w = acc[i][hj * 4 + 3] * sc.w;
      *reinterpret_cast<float4*>(out + (int64_t)m * N + n) = o;
    }
  }
}

}  // namespace

extern "C" {

// a_bf16: 0 = float32 activations, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 = launched).
int quantized_matmul_launch(const void* a, const void* w, const void* scale, void* out,
                            int M, int N, int K, int a_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                          // clear any stale error
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (a_bf16) {
    quantized_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N, K);
  } else {
    quantized_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* quantized_matmul_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
