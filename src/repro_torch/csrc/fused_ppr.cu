// One full eq. (1) PPR iteration over the pad-free dst stream:
//   P_next = α·X·P + α/|V|·(d̄ᵀP)·1 + (1−α)·V̄,   plus the |P_next − P|
//   residual per column (L1, ∞, Σd²) that drives early exit.
//
// Replaces the TPU kernel src/repro/kernels/fused_ppr.py::fused_ppr_iteration
// (bodies _kernel_float_fused / _kernel_fixed_fused, helpers
// _spmv_accumulate_*, _fold_dangling, _fold_residual, _sat_add_u32).
//
// The Pallas grid runs in order, so its dangling-mass prologue is complete
// before the first combine.  CUDA CTAs run concurrently and in no order, so
// the iteration is two launches on one stream, and nothing else (no memset):
//   (A) spmv_dangling_kernel — the SpMV of dst_stream.cuh into xp [V, K]
//       (one warp a slice of the stream, balanced by edges, whatever the
//       skew) and carry [chunks, K]; its first n_part CTAs also fold slices
//       of dang_idx into dangling-mass partials, and the last of them to
//       finish folds those into dm [K] in a fixed order;
//   (B) combine_kernel — row-parallel over [V, K]: closes the rows cut by
//       slice boundaries (carry partials in slice order), applies the eq. (1)
//       combine, writes P_next and folds the residual into one partial a CTA
//       (rows in a fixed order); the last CTA folds those into res [3, K]
//       (L1 and Σd² summed in a fixed order, ∞ by max: all deterministic).
// An empty row's X·P is 0.  A zero ∞-residual stays an exact bit-equality
// certificate: a raw diff of 1 converts to 1.0f and max never rounds to 0.
//
// Float combine uses __fmul_rn/__fadd_rn in the reference's order
// ((α·xp + α/|V|·dm) + (1−α)·v̄) so that no multiply-add is contracted.
// Fixed combine: sat_add(sat_add(mul(α,xp), mul(α/|V|,dm)), mul(1−α,v̄)),
// mul = low 32 bits of (a·b) >> f, sat_add saturates on wrap or > max_raw.
//
// Bound on the H100: bytes — 4 + 4 B per edge (col, val), row_ptr, P and V̄
// read once, P_next written once, the dangling rows of P once.  xp and the
// partials are extra traffic (xp: one write and one read of [V, K]).
#include <cstdint>
#include <cuda_runtime.h>

#include "dst_stream.cuh"

namespace {

using namespace dst_stream;

__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b, uint32_t max_raw) {
  const uint32_t s = a + b;
  return (s < a || s > max_raw) ? max_raw : s;
}

constexpr int kCombineThreads = 512;   // read by kernels/fused_ppr.py

struct Combine {
  int frac_bits;
  uint32_t a_raw, aov_raw, oma_raw, max_raw;
  float alpha_f, aov_f, oma_f;
};

template <bool FIXED, int VW>
__global__ void __launch_bounds__(kThreads)
spmv_dangling_kernel(const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
                     const uint32_t* __restrict__ val, const int32_t* __restrict__ nz_rows,
                     const int32_t* __restrict__ slice_row,
                     const uint32_t* __restrict__ p, uint32_t* __restrict__ xp,
                     uint32_t* __restrict__ carry, int n_edges, int slice_edges, int k,
                     int frac_bits,
                     const int32_t* __restrict__ dang_idx, int n_dang, int per_cta,
                     int n_part, uint32_t* __restrict__ dm_part,
                     uint32_t* __restrict__ dm, unsigned int* ticket) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t scratch[kThreads];
  spmv_cta<FIXED, VW>(row_ptr, col, val, nz_rows, slice_row, p, n_edges, slice_edges, k,
                      frac_bits, smem, xp, carry);
  dangling_mass_cta<FIXED>(p, dang_idx, n_dang, per_cta, n_part, k, dm_part, dm,
                           ticket, scratch);
}

template <bool FIXED, int VW>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int32_t* __restrict__ row_ptr, const uint32_t* __restrict__ xp,
               const uint32_t* __restrict__ carry, const uint32_t* __restrict__ p,
               const uint32_t* __restrict__ vmat, const uint32_t* __restrict__ dm,
               uint32_t* __restrict__ p_next, float* __restrict__ res_part,
               float* __restrict__ res, unsigned int* ticket, int n_rows,
               int rows_per_cta, int slice_edges, int k, Combine cc) {
  __shared__ uint32_t red[3][kCombineThreads * VW];
  const int cg_total = k / VW;
  const int cgb = min(cg_total, kCombineThreads);   // column groups a pass
  const int lanes = kCombineThreads / cgb;          // rows a pass
  const int t = threadIdx.x;
  const int rl = t / cgb, cgl = t - rl * cgb;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(r0 + rows_per_cta, n_rows);
  float* part = res_part + (int64_t)blockIdx.x * 3 * k;
  for (int cb = 0; cb < cg_total; cb += cgb) {
    const int cg = cb + cgl;
    const int c0 = cg * VW;
    float l1[VW], inf[VW], sq[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) l1[i] = inf[i] = sq[i] = 0.0f;
    if (rl < lanes && cg < cg_total) {
      uint32_t dmk[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) dmk[i] = dm[c0 + i];
#pragma unroll 2
      for (int r = r0 + rl; r < r1; r += lanes) {
        const int rs = __ldg(row_ptr + r), re = __ldg(row_ptr + r + 1);
        const int64_t idx = (int64_t)r * k + c0;
        uint32_t x[VW], prev[VW], vm[VW], pn[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) x[i] = 0u;
        if (re > rs) {
          ldg_vec<VW>(xp + idx, x);
          close_row<FIXED, VW>(carry, rs, re, kWarps * slice_edges, k, c0, x);
        }
        ldg_vec<VW>(p + idx, prev);
        ldg_vec<VW>(vmat + idx, vm);
#pragma unroll
        for (int i = 0; i < VW; ++i) {
          float diff;
          if (FIXED) {
            const int f = cc.frac_bits;
            pn[i] = sat_add(sat_add(mul_q(cc.a_raw, x[i], f), mul_q(cc.aov_raw, dmk[i], f),
                                    cc.max_raw),
                            mul_q(cc.oma_raw, vm[i], f), cc.max_raw);
            diff = __uint2float_rn(pn[i] > prev[i] ? pn[i] - prev[i] : prev[i] - pn[i]);
          } else {
            const float fv = __fadd_rn(
                __fadd_rn(__fmul_rn(cc.alpha_f, __uint_as_float(x[i])),
                          __fmul_rn(cc.aov_f, __uint_as_float(dmk[i]))),
                __fmul_rn(cc.oma_f, __uint_as_float(vm[i])));
            pn[i] = __float_as_uint(fv);
            diff = fabsf(__fsub_rn(fv, __uint_as_float(prev[i])));
          }
          l1[i] = __fadd_rn(l1[i], diff);
          inf[i] = fmaxf(inf[i], diff);
          sq[i] = __fadd_rn(sq[i], __fmul_rn(diff, diff));
        }
        store_vec<VW>(p_next + idx, pn);
      }
    }
    // this CTA's partial for the pass's columns: row lanes folded in order
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      red[0][t * VW + i] = __float_as_uint(l1[i]);
      red[1][t * VW + i] = __float_as_uint(inf[i]);
      red[2][t * VW + i] = __float_as_uint(sq[i]);
    }
    __syncthreads();
    if (rl == 0 && cg < cg_total) {
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        float a = 0.0f, m = 0.0f, q = 0.0f;
        for (int l = 0; l < lanes; ++l) {
          const int j = (l * cgb + cgl) * VW + i;
          a = __fadd_rn(a, __uint_as_float(red[0][j]));
          m = fmaxf(m, __uint_as_float(red[1][j]));
          q = __fadd_rn(q, __uint_as_float(red[2][j]));
        }
        part[c0 + i] = a;
        part[k + c0 + i] = m;
        part[2 * k + c0 + i] = q;
      }
    }
    __syncthreads();
  }
  if (last_cta(ticket, gridDim.x)) {
    const uint32_t* parts = reinterpret_cast<const uint32_t*>(res_part);
    const int width = 3 * k;
    fold_rows<false>([&](int j, int c) { return __ldcg(parts + (int64_t)j * width + c); },
                     gridDim.x, width, reinterpret_cast<uint32_t*>(res), &red[0][0], k,
                     2 * k);
  }
}

template <bool FIXED>
__global__ void __launch_bounds__(kThreads)
dangling_mass_kernel(const uint32_t* __restrict__ p, const int32_t* __restrict__ dang_idx,
                     int n_dang, int per_cta, int k, uint32_t* __restrict__ dm_part,
                     uint32_t* __restrict__ dm, unsigned int* ticket) {
  __shared__ uint32_t scratch[kThreads];
  dangling_mass_cta<FIXED>(p, dang_idx, n_dang, per_cta, gridDim.x, k, dm_part, dm,
                           ticket, scratch);
}

struct Iteration {
  const void *row_ptr, *col, *val, *nz_rows, *slice_row, *p, *vmat, *dang_idx;
  void *xp, *carry, *dm_part, *dm, *p_next, *res_part, *res, *tickets;
  int n_rows, n_edges, n_ctas, slice_edges, k, n_dang, per_cta, n_part, combine_ctas,
      rows_per_cta;
};

template <bool FIXED, int VW>
void launch(const Iteration& it, const Combine& cc, cudaStream_t s) {
  const int smem = (int)sizeof(uint32_t) * kWarps * warp_words(it.slice_edges);
  auto a = spmv_dangling_kernel<FIXED, VW>;
  cudaFuncSetAttribute(a, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  unsigned int* tickets = static_cast<unsigned int*>(it.tickets);
  a<<<it.n_ctas, kThreads, smem, s>>>(
      static_cast<const int32_t*>(it.row_ptr), static_cast<const int32_t*>(it.col),
      static_cast<const uint32_t*>(it.val), static_cast<const int32_t*>(it.nz_rows),
      static_cast<const int32_t*>(it.slice_row), static_cast<const uint32_t*>(it.p),
      static_cast<uint32_t*>(it.xp), static_cast<uint32_t*>(it.carry), it.n_edges,
      it.slice_edges, it.k, cc.frac_bits, static_cast<const int32_t*>(it.dang_idx), it.n_dang, it.per_cta,
      it.n_part, static_cast<uint32_t*>(it.dm_part), static_cast<uint32_t*>(it.dm),
      tickets);
  combine_kernel<FIXED, VW><<<it.combine_ctas, kCombineThreads, 0, s>>>(
      static_cast<const int32_t*>(it.row_ptr), static_cast<const uint32_t*>(it.xp),
      static_cast<const uint32_t*>(it.carry), static_cast<const uint32_t*>(it.p),
      static_cast<const uint32_t*>(it.vmat), static_cast<const uint32_t*>(it.dm),
      static_cast<uint32_t*>(it.p_next), static_cast<float*>(it.res_part),
      static_cast<float*>(it.res), tickets + 1, it.n_rows, it.rows_per_cta,
      it.slice_edges, it.k, cc);
}

}  // namespace

extern "C" {

// dm[k] = Σ_{i in dang_idx} P[i, k] over `n_part` CTAs of `per_cta` rows each
// (dm_part: [n_part, k] scratch; ticket: one zeroed word, left zeroed).
// Returns cudaGetLastError().
int dangling_mass_launch(const void* p, const void* dang_idx, int n_dang, int per_cta,
                         int n_part, int k, int fixed, void* dm_part, void* dm,
                         void* ticket, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  auto fn = fixed ? dangling_mass_kernel<true> : dangling_mass_kernel<false>;
  fn<<<n_part, kThreads, 0, s>>>(static_cast<const uint32_t*>(p),
                                 static_cast<const int32_t*>(dang_idx), n_dang, per_cta, k,
                                 static_cast<uint32_t*>(dm_part), static_cast<uint32_t*>(dm),
                                 static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// One iteration: kernels (A) and (B).  frac_bits < 0 selects float32; vec is
// 4 (k % 4 == 0, 16 B aligned state) or 1.  tickets: two zeroed words, left
// zeroed.  Returns cudaGetLastError() after both launches.
int fused_ppr_launch(const void* row_ptr, const void* col, const void* val,
                     const void* nz_rows, const void* slice_row, const void* dang_idx, const void* vmat,
                     const void* p, void* xp, void* carry, void* dm_part, void* dm,
                     void* p_next, void* res_part, void* res, void* tickets, int n_rows,
                     int n_edges, int n_ctas, int slice_edges, int k, int n_dang,
                     int per_cta, int n_part, int combine_ctas, int rows_per_cta,
                     int frac_bits, uint32_t a_raw, uint32_t aov_raw, uint32_t oma_raw,
                     uint32_t max_raw, float alpha_f, float aov_f, float oma_f, int vec,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const Iteration it{row_ptr, col, val, nz_rows, slice_row, p, vmat, dang_idx, xp, carry,
                     dm_part, dm, p_next, res_part, res, tickets, n_rows, n_edges,
                     n_ctas, slice_edges, k, n_dang, per_cta, n_part, combine_ctas,
                     rows_per_cta};
  const bool fixed = frac_bits >= 0;
  const Combine cc{fixed ? frac_bits : 0, a_raw, aov_raw, oma_raw, max_raw,
                   alpha_f, aov_f, oma_f};
  if (fixed && vec == 4) launch<true, 4>(it, cc, s);
  else if (fixed) launch<true, 1>(it, cc, s);
  else if (vec == 4) launch<false, 4>(it, cc, s);
  else launch<false, 1>(it, cc, s);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_ppr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
