// One full eq. (1) PPR iteration over the fused dst-major packet layout:
//   P_next = α·X·P + α/|V|·(d̄ᵀP)·1 + (1−α)·V̄,   plus the |P_next − P|
//   residual per column (L1, ∞, Σd²) that drives early exit.
//
// Replaces the TPU kernel src/repro/kernels/fused_ppr.py::fused_ppr_iteration
// (bodies _kernel_float_fused / _kernel_fixed_fused, helpers
// _spmv_accumulate_*, _valid_rows, _fold_residual, _sat_add_u32).
//
// The Pallas grid runs in order, so its dangling-mass prologue is complete
// before the first combine.  CUDA blocks run concurrently and in no order, so
// the iteration is two launches on one stream:
//   (a) dangling_mass_kernel — one block folds dm[k] = Σ_{i dangling} P[i,k]
//       in a fixed order (float: deterministic; fixed: a uint32 sum that
//       wraps mod 2^32 like the reference's int32 sum);
//   (b) fused_ppr_kernel — one block per dst block walks that block's packet
//       rows [row_off[d], row_off[d+1]) into a v_tile x K shared-memory
//       accumulator (as in coo_spmv.cu), then applies the eq. (1) combine with
//       the host's constants, writes the rows below |V|, and folds the
//       residual: ∞ by atomicMax on the bits of a non-negative f32 (exact),
//       L1 and Σd² by f32 atomicAdd (order-dependent: a tolerance).
// An empty dst block has no rows; its combine still runs (acc = 0), like the
// reference's sentinel step.  A zero ∞-residual stays an exact bit-equality
// certificate: a raw diff of 1 converts to 1.0f and max never rounds to 0.
//
// Float combine uses __fmul_rn/__fadd_rn in the reference's order
// ((α·xp + α/|V|·dm) + (1−α)·v̄) so that no multiply-add is contracted.
// Fixed combine: sat_add(sat_add(mul(α,xp), mul(α/|V|,dm)), mul(1−α,v̄)),
// mul = low 32 bits of (a·b) >> f, sat_add saturates on wrap or > max_raw.
//
// Bound on the H100: bytes — 2 + 2 + 4 B per real edge and 4 B per pad slot
// (pads are skipped after their value is read, as in coo_spmv.cu), P read,
// V̄ read, P_next written.  Two launches per iteration; fusing
// (a) into the previous iteration's epilogue is left to a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mul_q(uint32_t a, uint32_t b, int f) {
  return (uint32_t)(((uint64_t)a * b) >> f);
}

__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b, uint32_t max_raw) {
  const uint32_t s = a + b;
  return (s < a || s > max_raw) ? max_raw : s;
}

template <bool FIXED>
__global__ void dangling_mass_kernel(const uint32_t* __restrict__ p,
                                     const int32_t* __restrict__ dang_idx,
                                     int n_dang, int k, uint32_t* __restrict__ dm) {
  extern __shared__ uint32_t part[];          // [blockDim.x]
  const int tid = threadIdx.x;
  const int kk = tid % k;
  const int lanes = blockDim.x / k;
  uint32_t su = 0u;
  float sf = 0.0f;
  for (int j = tid / k; j < n_dang; j += lanes) {
    const uint32_t v = p[(int64_t)dang_idx[j] * k + kk];
    if (FIXED) su += v;
    else sf = __fadd_rn(sf, __uint_as_float(v));
  }
  part[tid] = FIXED ? su : __float_as_uint(sf);
  __syncthreads();
  if (tid < k) {                              // fixed-order fold over the lanes
    uint32_t tu = 0u;
    float tf = 0.0f;
    for (int l = 0; l < lanes; ++l) {
      const uint32_t v = part[l * k + tid];
      if (FIXED) tu += v;
      else tf = __fadd_rn(tf, __uint_as_float(v));
    }
    dm[tid] = FIXED ? tu : __float_as_uint(tf);
  }
}

template <bool FIXED>
__global__ void fused_ppr_kernel(const int32_t* __restrict__ row_off,
                                 const int32_t* __restrict__ row_src,
                                 const uint16_t* __restrict__ x2,
                                 const uint16_t* __restrict__ y2,
                                 const uint32_t* __restrict__ val2,
                                 const uint32_t* __restrict__ p,
                                 const uint32_t* __restrict__ vmat,
                                 const uint32_t* __restrict__ dm,
                                 uint32_t* __restrict__ p_next,
                                 float* __restrict__ res,
                                 int num_vertices, int v_tile, int packet, int k,
                                 int frac_bits, uint32_t a_raw, uint32_t aov_raw,
                                 uint32_t oma_raw, uint32_t max_raw,
                                 float alpha_f, float aov_f, float oma_f) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                       // [v_tile * k]
  float* red_l1 = reinterpret_cast<float*>(smem + v_tile * k);   // [k]
  uint32_t* red_inf = smem + v_tile * k + k;                       // [k] f32 bits
  float* red_sq = reinterpret_cast<float*>(smem + v_tile * k + 2 * k);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                  // a multiple of k
  const int kk = tid % k;
  const int lanes = nt / k;
  const int tile = v_tile * k;
  for (int i = tid; i < tile + 3 * k; i += nt) smem[i] = 0u;
  __syncthreads();

  const int d = blockIdx.x;
  const int r0 = row_off[d];
  const int r1 = row_off[d + 1];
  for (int r = r0; r < r1; ++r) {
    const int64_t base = (int64_t)r * packet;
    const int64_t src_row0 = (int64_t)row_src[r] * v_tile;
    for (int e = tid / k; e < packet; e += lanes) {
      const uint32_t v = val2[base + e];
      if (v == 0u) continue;                  // pad slot: contributes exactly 0
      const int xl = x2[base + e];
      const int yl = y2[base + e];
      const uint32_t pv = p[(src_row0 + yl) * k + kk];
      if (FIXED) {
        atomicAdd(&acc[xl * k + kk], mul_q(v, pv, frac_bits));
      } else {
        atomicAdd(reinterpret_cast<float*>(&acc[xl * k + kk]),
                  __fmul_rn(__uint_as_float(v), __uint_as_float(pv)));
      }
    }
  }
  __syncthreads();

  const uint32_t dmk = dm[kk];
  float l1 = 0.0f, inf = 0.0f, sq = 0.0f;
  const int64_t row0 = (int64_t)d * v_tile;
  for (int i = tid / k; i < v_tile; i += lanes) {
    const int64_t g = row0 + i;
    if (g >= num_vertices) break;             // pad rows of the ragged last block
    const int64_t idx = g * k + kk;
    const uint32_t xp = acc[i * k + kk];
    const uint32_t prev = p[idx];
    float diff;
    uint32_t pn;
    if (FIXED) {
      pn = sat_add(sat_add(mul_q(a_raw, xp, frac_bits), mul_q(aov_raw, dmk, frac_bits),
                           max_raw),
                   mul_q(oma_raw, vmat[idx], frac_bits), max_raw);
      diff = __uint2float_rn(pn > prev ? pn - prev : prev - pn);
    } else {
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(alpha_f, __uint_as_float(xp)),
                    __fmul_rn(aov_f, __uint_as_float(dmk))),
          __fmul_rn(oma_f, __uint_as_float(vmat[idx])));
      pn = __float_as_uint(f);
      diff = fabsf(__fsub_rn(f, __uint_as_float(prev)));
    }
    p_next[idx] = pn;
    l1 = __fadd_rn(l1, diff);
    inf = fmaxf(inf, diff);
    sq = __fadd_rn(sq, __fmul_rn(diff, diff));
  }
  atomicAdd(&red_l1[kk], l1);
  atomicMax(&red_inf[kk], __float_as_uint(inf));   // non-negative f32: bits order
  atomicAdd(&red_sq[kk], sq);
  __syncthreads();
  if (tid < k) {
    atomicAdd(&res[tid], red_l1[tid]);
    atomicMax(reinterpret_cast<unsigned int*>(&res[k + tid]), red_inf[tid]);
    atomicAdd(&res[2 * k + tid], red_sq[tid]);
  }
}

}  // namespace

extern "C" {

// (a) dm[k] = Σ_{i in dang_idx} P[i, k].  Returns cudaGetLastError().
int dangling_mass_launch(const void* p, const void* dang_idx, int n_dang, int k,
                         int fixed, void* dm, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const size_t smem = sizeof(uint32_t) * threads;
  if (fixed) {
    dangling_mass_kernel<true><<<1, threads, smem, s>>>(
        static_cast<const uint32_t*>(p), static_cast<const int32_t*>(dang_idx),
        n_dang, k, static_cast<uint32_t*>(dm));
  } else {
    dangling_mass_kernel<false><<<1, threads, smem, s>>>(
        static_cast<const uint32_t*>(p), static_cast<const int32_t*>(dang_idx),
        n_dang, k, static_cast<uint32_t*>(dm));
  }
  return static_cast<int>(cudaGetLastError());
}

// (b) the SpMV + combine + residual over n_blk dst blocks.  frac_bits < 0
// selects float32.  Returns cudaGetLastError().
int fused_ppr_launch(const void* row_off, const void* row_src, const void* x2,
                     const void* y2, const void* val2, const void* p,
                     const void* vmat, const void* dm, void* p_next, void* res,
                     int n_blk, int num_vertices, int v_tile, int packet, int k,
                     int frac_bits, uint32_t a_raw, uint32_t aov_raw,
                     uint32_t oma_raw, uint32_t max_raw, float alpha_f,
                     float aov_f, float oma_f, int threads, int smem_bytes,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const bool fixed = frac_bits >= 0;
  auto fn = fixed ? fused_ppr_kernel<true> : fused_ppr_kernel<false>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  fn<<<n_blk, threads, smem_bytes, s>>>(
      static_cast<const int32_t*>(row_off), static_cast<const int32_t*>(row_src),
      static_cast<const uint16_t*>(x2), static_cast<const uint16_t*>(y2),
      static_cast<const uint32_t*>(val2), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(vmat), static_cast<const uint32_t*>(dm),
      static_cast<uint32_t*>(p_next), static_cast<float*>(res), num_vertices,
      v_tile, packet, k, fixed ? frac_bits : 0, a_raw, aov_raw, oma_raw, max_raw,
      alpha_f, aov_f, oma_f);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_ppr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
