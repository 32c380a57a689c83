// Streaming COO SpMM out = X·P over the 2-D BlockedCOO layout (paper §4.1.1).
//
// Replaces the TPU kernel src/repro/kernels/coo_spmv.py::coo_spmv_pallas
// (bodies _kernel_float / _kernel_fixed, limb multiply _fixed_mul_u32).
//
// Grid: one CUDA block per dst tile.  BlockedCOO is dst-major, so a dst
// tile's packets are one contiguous range [dst_start[d], dst_start[d+1]).
// The block keeps the v_tile x K accumulator in shared memory (the VMEM
// accumulator of the TPU kernel; 512 x 16 x 4 B = 32 KB at the paper's
// sizes), walks its packets, and writes the tile to global memory once.
// A dst tile with no packets is written as zeros.
//
// Thread map: thread t owns column kk = t % K and edge lane t / K; the
// block sweeps a packet's edges `lanes` at a time.  Per edge the thread
//   - gathers P[src_blk * v_tile + y_local, kk] from global memory (P is
//     12.8 MB at |V| = 2e5, K = 16, and stays in the 50 MB L2);
//   - multiplies: f32, or (uint32)(((uint64)a * b) >> f), which equals the
//     reference's 16-bit-limb multiply for every uint32 pair;
//   - adds into shared memory with atomicAdd.  A uint32 add wraps mod 2^32,
//     exactly like the reference's int32 one-hot dot; the float sum's order
//     differs from the reference's, so float parity holds to a tolerance.
// Pad slots (val == 0) are skipped: their product is exactly 0 in both
// domains for finite P, so skipping them changes no bit.
//
// Bound on the H100: bytes — 2 + 2 + 4 B per real edge, 4 B per pad slot
// (its value is read, its indices are not), plus P and out.  The BlockedCOO
// padding makes the stream 10.8x (pl_2e5) to 18.6x (gnp_2e5) longer than the
// edge count; this first kernel keeps the reference layout and skips the
// pads' index loads, gathers and atomics, so its extra cost is the pads'
// 4 B value read each and the walk over their slots.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool FIXED>
__global__ void coo_spmv_kernel(const uint16_t* __restrict__ x_local,
                                const uint16_t* __restrict__ y_local,
                                const uint32_t* __restrict__ val,
                                const uint32_t* __restrict__ p,
                                const int32_t* __restrict__ dst_start,
                                const int32_t* __restrict__ packet_src,
                                uint32_t* __restrict__ out,
                                int v_tile, int packet, int k, int frac_bits) {
  extern __shared__ uint32_t acc[];          // [v_tile * k], f32 or uint32 bits
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                  // a multiple of k
  const int kk = tid % k;
  const int lanes = nt / k;
  const int tile = v_tile * k;
  for (int i = tid; i < tile; i += nt) acc[i] = 0u;
  __syncthreads();

  const int d = blockIdx.x;
  const int p0 = dst_start[d];
  const int p1 = dst_start[d + 1];
  for (int pk = p0; pk < p1; ++pk) {
    const int64_t base = (int64_t)pk * packet;
    const int64_t src_row0 = (int64_t)packet_src[pk] * v_tile;
    for (int e = tid / k; e < packet; e += lanes) {
      const uint32_t v = val[base + e];
      if (v == 0u) continue;                  // pad slot: contributes exactly 0
      const int xl = x_local[base + e];
      const int yl = y_local[base + e];
      const uint32_t pv = p[(src_row0 + yl) * k + kk];
      if (FIXED) {
        const uint32_t prod = (uint32_t)(((uint64_t)v * pv) >> frac_bits);
        atomicAdd(&acc[xl * k + kk], prod);
      } else {
        atomicAdd(reinterpret_cast<float*>(&acc[xl * k + kk]),
                  __fmul_rn(__uint_as_float(v), __uint_as_float(pv)));
      }
    }
  }
  __syncthreads();
  uint32_t* dst = out + (int64_t)d * tile;
  for (int i = tid; i < tile; i += nt) dst[i] = acc[i];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int coo_spmv_launch(const void* x_local, const void* y_local, const void* val,
                    const void* p, const void* dst_start, const void* packet_src,
                    void* out, int n_dst, int v_tile, int packet, int k,
                    int frac_bits, int threads, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                         // clear any stale error
  if (frac_bits >= 0) {
    auto fn = coo_spmv_kernel<true>;
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    fn<<<n_dst, threads, smem_bytes, s>>>(
        static_cast<const uint16_t*>(x_local), static_cast<const uint16_t*>(y_local),
        static_cast<const uint32_t*>(val), static_cast<const uint32_t*>(p),
        static_cast<const int32_t*>(dst_start), static_cast<const int32_t*>(packet_src),
        static_cast<uint32_t*>(out), v_tile, packet, k, frac_bits);
  } else {
    auto fn = coo_spmv_kernel<false>;
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    fn<<<n_dst, threads, smem_bytes, s>>>(
        static_cast<const uint16_t*>(x_local), static_cast<const uint16_t*>(y_local),
        static_cast<const uint32_t*>(val), static_cast<const uint32_t*>(p),
        static_cast<const int32_t*>(dst_start), static_cast<const int32_t*>(packet_src),
        static_cast<uint32_t*>(out), v_tile, packet, k, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* coo_spmv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
