// Streaming COO SpMM out = X·P (paper §4.1.1) over the pad-free dst stream.
//
// Replaces the TPU kernel src/repro/kernels/coo_spmv.py::coo_spmv_pallas
// (bodies _kernel_float / _kernel_fixed, limb multiply _fixed_mul_u32), which
// streams the BlockedCOO packets.  The port reads the same edges as CSR over
// dst rows without the packets' pad slots (kernels/dst_stream.py), so the
// function computed is the same: out[i] = Σ_{e: dst(e) = i} val[e] · P[src(e)],
// a float32 sum, or truncating Qm.f products summed mod 2^32 in raw bits.
//
// Two launches on one stream:
//   (a) spmv_kernel — one warp a slice of the stream, kWarps a CTA (the SpMV
//       of dst_stream.cuh): each slot of a warp walks a run of edges, rows are
//       summed in registers and stored once; rows cut by a slice boundary
//       leave partials;
//   (b) fixup_kernel — one thread a (row, column group): writes empty rows as
//       0 and adds the carry partials of cut rows in slice order.
//
// Bound on the H100: bytes — 4 + 4 B per edge (col, val), row_ptr, P and the
// output once.  The gathers of P rows (64 B at K = 16) hit the 50 MB L2 (P is
// 12.8 MB at |V| = 2e5), so HBM moves the stream and P once.  The design
// keeps the card busy with ~1,000 CTAs whatever the skew (a hub row spans
// many slices, a run of one-edge rows costs what a long row does, empty rows
// cost the SpMV nothing) and keeps four gathers in flight a lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "dst_stream.cuh"

namespace {

using namespace dst_stream;

template <bool FIXED, int VW>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
            const uint32_t* __restrict__ val, const int32_t* __restrict__ nz_rows,
            const int32_t* __restrict__ slice_row, const uint32_t* __restrict__ p,
            uint32_t* __restrict__ out, uint32_t* __restrict__ carry, int n_edges,
            int slice_edges, int k, int frac_bits) {
  extern __shared__ uint32_t smem[];
  spmv_cta<FIXED, VW>(row_ptr, col, val, nz_rows, slice_row, p, n_edges, slice_edges, k,
                      frac_bits, smem, out, carry);
}

template <bool FIXED, int VW>
__global__ void __launch_bounds__(kThreads)
fixup_kernel(const int32_t* __restrict__ row_ptr, const uint32_t* __restrict__ carry,
             uint32_t* __restrict__ out, int n_rows, int slice_edges, int k) {
  const int cg_total = k / VW;
  const int chunk = kWarps * slice_edges;
  const int64_t items = (int64_t)n_rows * cg_total;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < items;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(idx / cg_total);
    const int c0 = (int)(idx - (int64_t)r * cg_total) * VW;
    const int rs = __ldg(row_ptr + r), re = __ldg(row_ptr + r + 1);
    uint32_t* o = out + (int64_t)r * k + c0;
    uint32_t x[VW];
    if (re == rs) {
#pragma unroll
      for (int i = 0; i < VW; ++i) x[i] = 0u;
      store_vec<VW>(o, x);
    } else if ((rs / chunk + 1) * (int64_t)chunk < re) {   // cut by a chunk boundary
      load_vec<VW>(o, x);
      close_row<FIXED, VW>(carry, rs, re, chunk, k, c0, x);
      store_vec<VW>(o, x);
    }
  }
}

template <bool FIXED, int VW>
void launch(const void* row_ptr, const void* col, const void* val, const void* nz_rows,
            const void* slice_row, const void* p, void* out, void* carry, int n_rows,
            int n_edges, int n_ctas, int slice_edges, int k, int frac_bits, int fix_ctas,
            cudaStream_t s) {
  const int smem = (int)sizeof(uint32_t) * kWarps * warp_words(slice_edges);
  auto a = spmv_kernel<FIXED, VW>;
  cudaFuncSetAttribute(a, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  a<<<n_ctas, kThreads, smem, s>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col),
      static_cast<const uint32_t*>(val), static_cast<const int32_t*>(nz_rows),
      static_cast<const int32_t*>(slice_row), static_cast<const uint32_t*>(p),
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(carry), n_edges, slice_edges,
      k, frac_bits);
  fixup_kernel<FIXED, VW><<<fix_ctas, kThreads, 0, s>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const uint32_t*>(carry),
      static_cast<uint32_t*>(out), n_rows, slice_edges, k);
}

}  // namespace

extern "C" {

// out [n_rows, k] = X·P.  frac_bits < 0 selects float32; vec is 4 (k % 4 == 0,
// 16 B aligned P and out) or 1.  Returns cudaGetLastError() after the launches.
int coo_spmv_launch(const void* row_ptr, const void* col, const void* val,
                    const void* nz_rows, const void* slice_row, const void* p, void* out,
                    void* carry, int n_rows, int n_edges, int n_ctas, int slice_edges, int k,
                    int frac_bits, int vec, int fix_ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                         // clear any stale error
  const bool fixed = frac_bits >= 0;
  const int f = fixed ? frac_bits : 0;
  auto fn = fixed ? (vec == 4 ? launch<true, 4> : launch<true, 1>)
                  : (vec == 4 ? launch<false, 4> : launch<false, 1>);
  fn(row_ptr, col, val, nz_rows, slice_row, p, out, carry, n_rows, n_edges, n_ctas,
     slice_edges, k, f, fix_ctas, s);
  return static_cast<int>(cudaGetLastError());
}

const char* coo_spmv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
