// Device code shared by coo_spmv.cu and fused_ppr.cu: the SpMV over the
// pad-free, dst-sorted edge stream of src/repro_torch/kernels/dst_stream.py
// (CSR over dst rows: row_ptr, col, val) and the fixed-order folds.
//
// Work is balanced by edges, not by dst rows.  The stream is cut into slices
// of `slice_edges` edges (a multiple of 32), one warp each, kWarps slices a
// CTA; slice s touches the non-empty rows nz_rows[slice_row[s] ..
// slice_row[s + 1]], so empty rows cost the SpMV nothing.  A warp:
//   1. stages its slice's col/val and its rows' starts and ids in shared
//      memory with coalesced loads;
//   2. splits the slice into runs of contiguous edges, one a slot.  Lanes own
//      columns: a lane holds VW = 4 columns (one 16 B load of a P row; K = 16
//      puts an edge's 64 B row in 4 lanes, 8 slots of 32 edges) or VW = 1
//      when K % 4 != 0, and 32 column groups at most, so K > 128 (or > 32 at
//      VW = 1) loops over column blocks.  A slot walks its run in order with
//      four gathers in flight a lane, whatever the rows' lengths: a hub row
//      or a run of one-edge rows costs the same;
//   3. sums rows in registers and stores a row once it ends; rows cut by a
//      run boundary are joined across the warp's slots, and rows cut by a
//      slice boundary across the CTA's warps, in order, through shared
//      memory.  No shared-memory or global atomics.
// A row that starts inside the CTA's chunk (kWarps slices) is stored to
// xp[row] (its whole sum, or the partial up to the chunk's end); the partial
// of a row that started in an earlier chunk (only the chunk's first row can
// have) goes to carry[chunk].  A row cut by chunk boundaries is closed by
// close_row: its owner's partial, then carry[j] for every chunk j that starts
// strictly inside the row, in increasing j: 9 partials for pl_2e5's
// 18,534-edge hub row at 256-edge slices.  That order is fixed, so float32 results are deterministic
// run to run; global atomics into a zeroed buffer would need a memset an
// iteration and give sums in a different order each run.  uint32 sums wrap
// mod 2^32 in any order, so Qm.f is raw-bit exact either way.  Empty rows are
// never written by the SpMV; the fix-up writes them as 0.
//
// Cross-CTA reductions (dangling mass, residual) write one partial a CTA;
// the last CTA to finish (atomicInc on a ticket that wraps back to 0, so the
// buffer is left zeroed for the next launch) folds them in a fixed order.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dst_stream {

constexpr int kWarps = 8;                  // read by kernels/coo_spmv.py
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mul_q(uint32_t a, uint32_t b, int f) {
  return (uint32_t)(((uint64_t)a * b) >> f);   // == the reference's limb multiply
}

template <bool FIXED>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if (FIXED) return a + b;                      // wraps mod 2^32
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}

template <bool FIXED>
__device__ __forceinline__ uint32_t madd(uint32_t acc, uint32_t v, uint32_t p, int f) {
  if (FIXED) return acc + mul_q(v, p, f);
  return __float_as_uint(__fadd_rn(__uint_as_float(acc),
                                   __fmul_rn(__uint_as_float(v), __uint_as_float(p))));
}

template <int VW>
__device__ __forceinline__ void load_vec(const uint32_t* src, uint32_t (&d)[VW]) {
  if constexpr (VW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  } else {
    d[0] = *src;
  }
}

template <int VW>
__device__ __forceinline__ void ldg_vec(const uint32_t* __restrict__ src, uint32_t (&d)[VW]) {
  if constexpr (VW == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  } else {
    d[0] = __ldg(src);
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(uint32_t* dst, const uint32_t (&d)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(d[0], d[1], d[2], d[3]);
  } else {
    dst[0] = d[0];
  }
}

// Shared words a warp stages its slice in: kWordsPerSliceEdge an edge (col,
// val, and the rows' starts and ids: at most slice_edges + 1 rows meet a
// slice) and kWarpFixedWords besides (the 4 words of that + 1 row, padded;
// head and tail partials of its 32 slots, 4 columns each; the slots' 3 row
// keys).  kernels/coo_spmv.py reads these constants from this file.
constexpr int kWordsPerSliceEdge = 4;
constexpr int kWarpFixedWords = 356;
static_assert(kWarpFixedWords == 4 + 2 * 32 * 4 + 3 * 32, "warp_words layout");
__host__ __device__ constexpr int warp_words(int slice_edges) {
  return kWordsPerSliceEdge * slice_edges + kWarpFixedWords;
}

// Joins the open rows of n parts (the slots of a warp, or the warps of a
// CTA) in part order.  Part j may hold a head, the partial of the row left
// open by part j - 1 (for part 0: a row begun before the parts), going on
// past part j if head_on[j]; and a tail, the partial of a row begun in part j
// that goes on past it.  A lane joins VW columns; part j's partials sit at
// heads[j * stride] and tails[j * stride].  close(key, first, sum, goes_on)
// gets each row as it closes and, with goes_on, the row still open after
// part n - 1; first says the row began before part 0.
template <bool FIXED, int VW, class Close>
__device__ __forceinline__ void join_parts(int n, const int32_t* head_key,
                                           const int32_t* head_on, const int32_t* tail_key,
                                           const uint32_t* heads, const uint32_t* tails,
                                           int stride, Close close) {
  int open = -1;
  bool first = false;
  uint32_t sum[VW];
#pragma unroll
  for (int i = 0; i < VW; ++i) sum[i] = 0u;
  for (int j = 0; j < n; ++j) {
    if (head_key[j] >= 0) {
      if (j == 0) {
        open = head_key[0];
        first = true;
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) sum[i] = add<FIXED>(sum[i], heads[j * stride + i]);
      if (!head_on[j]) {
        close(open, first, sum, false);
        open = -1;
#pragma unroll
        for (int i = 0; i < VW; ++i) sum[i] = 0u;
      }
    }
    if (tail_key[j] >= 0) {
      open = tail_key[j];
      first = false;
#pragma unroll
      for (int i = 0; i < VW; ++i) sum[i] = tails[j * stride + i];
    }
  }
  if (open >= 0) close(open, first, sum, true);
}

// The SpMV of this CTA's chunk of kWarps slices of the stream (dynamic
// shared memory: kWarps * warp_words(slice_edges) words).  Warp w takes
// slice s = blockIdx.x * kWarps + w: edges [e0, e1), touching the non-empty
// rows nz_rows[slice_row[s] .. slice_row[s + 1]].  It stages col, val and the
// rows' starts (row_ptr[nz_rows[q]]) in shared memory.  Lanes own columns (VW
// a lane, at most 32 column groups a pass); the ep = 32 / lanes edge slots
// of a pass each walk a contiguous run of slice_edges / ep edges in order,
// four gathers in flight a lane, summing each row in registers: a row that
// ends inside a run is stored at once.  Rows cut by a run boundary are
// joined across the warp's slots, then rows cut by a slice boundary across
// the CTA's warps, in order.  A row begun in the chunk goes to xp[row] (its
// whole sum, or its partial up to the chunk's end); the partial of a row
// begun before the chunk goes to carry[blockIdx.x].
template <bool FIXED, int VW>
__device__ void spmv_cta(const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ col,
                         const uint32_t* __restrict__ val,
                         const int32_t* __restrict__ nz_rows,
                         const int32_t* __restrict__ slice_row,
                         const uint32_t* __restrict__ p, int n_edges, int slice_edges,
                         int k, int frac_bits, uint32_t* smem,
                         uint32_t* __restrict__ xp, uint32_t* __restrict__ carry) {
  __shared__ uint32_t c_head[kWarps][32 * 4], c_tail[kWarps][32 * 4];
  __shared__ int32_t c_key[3][kWarps];         // head row, head goes on, tail row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  const bool has = (int64_t)s * slice_edges < n_edges;   // warp-uniform
  const int e0 = s * slice_edges;
  const int e1 = has ? min(e0 + slice_edges, n_edges) : e0;
  const int q0 = has ? __ldg(slice_row + s) : 0;
  const int nr = has ? __ldg(slice_row + s + 1) - q0 + 1 : 0;   // rows staged
  uint32_t* ws = smem + warp * warp_words(slice_edges);
  int32_t* s_col = reinterpret_cast<int32_t*>(ws);
  uint32_t* s_val = ws + slice_edges;
  int32_t* s_ptr = reinterpret_cast<int32_t*>(ws + 2 * slice_edges);      // nr + 1
  int32_t* s_row = reinterpret_cast<int32_t*>(ws + 3 * slice_edges + 2);  // nr
  uint32_t* s_head = ws + 4 * slice_edges + 4;                            // 32 * 4
  uint32_t* s_tail = s_head + 32 * 4;                                     // 32 * 4
  int32_t* s_key = reinterpret_cast<int32_t*>(s_tail + 32 * 4);           // 3 * 32
#pragma unroll 4
  for (int i = lane; i < e1 - e0; i += 32) {
    s_col[i] = __ldg(col + e0 + i);
    s_val[i] = __ldg(val + e0 + i);
  }
  for (int i = lane; i < nr; i += 32) {
    const int r = __ldg(nz_rows + q0 + i);
    s_row[i] = r;
    s_ptr[i] = __ldg(row_ptr + r);
    if (i == nr - 1) s_ptr[nr] = __ldg(row_ptr + r + 1);
  }
  __syncwarp();
  const int cg_total = k / VW;
  for (int cb = 0; cb < cg_total; cb += 32) {
    const int ng = min(32, cg_total - cb);     // column groups in this pass
    int lanes = 1;                              // lanes an edge: pow2 >= ng
    while (lanes < ng) lanes <<= 1;
    const int ep = 32 / lanes;                  // edge slots
    const int slot = lane / lanes;
    const int cgl = lane - slot * lanes;
    const bool active = cgl < ng;
    const int c0 = (cb + cgl) * VW;
    const int run = slice_edges / ep;
    const int a = e0 + slot * run, b = min(a + run, e1);
    int head = -1, head_on = 0, tail = -1;      // local rows; head goes on past b
    uint32_t hv[VW], tv[VW], acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) hv[i] = tv[i] = acc[i] = 0u;
    if (a < e1) {
      int lo = 0, hi = nr - 1;                  // last row starting at or before a
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_ptr[mid] <= a) lo = mid; else hi = mid - 1;
      }
      int lr = lo, r_start = s_ptr[lo], r_end = s_ptr[lo + 1];
      for (int e = a; e < b; e += 4) {
        uint32_t v[4], pv[4][VW];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int eu = e + u;
          v[u] = 0u;
#pragma unroll
          for (int i = 0; i < VW; ++i) pv[u][i] = 0u;
          if (active && eu < b) {
            v[u] = s_val[eu - e0];
            ldg_vec<VW>(p + (int64_t)s_col[eu - e0] * k + c0, pv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int eu = e + u;
          if (eu < b) {
            if (eu == r_end) {                  // row lr ended before eu
              if (r_start < a) {
                head = lr;
#pragma unroll
                for (int i = 0; i < VW; ++i) hv[i] = acc[i];
              } else if (active) {
                store_vec<VW>(xp + (int64_t)s_row[lr] * k + c0, acc);
              }
#pragma unroll
              for (int i = 0; i < VW; ++i) acc[i] = 0u;
              ++lr;
              r_start = r_end;
              r_end = s_ptr[lr + 1];
            }
#pragma unroll
            for (int i = 0; i < VW; ++i) acc[i] = madd<FIXED>(acc[i], v[u], pv[u][i], frac_bits);
          }
        }
      }
      // the run's last row, lr
      if (r_start < a) {                        // also its first: a head
        head = lr;
        head_on = r_end > b;
#pragma unroll
        for (int i = 0; i < VW; ++i) hv[i] = acc[i];
      } else if (r_end > b) {                   // goes on past the run
        tail = lr;
#pragma unroll
        for (int i = 0; i < VW; ++i) tv[i] = acc[i];
      } else if (active) {
        store_vec<VW>(xp + (int64_t)s_row[lr] * k + c0, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      s_head[lane * VW + i] = hv[i];
      s_tail[lane * VW + i] = tv[i];
    }
    if (cgl == 0) {
      s_key[slot] = head;
      s_key[32 + slot] = head_on;
      s_key[64 + slot] = tail;
    }
    if (lane == 0) c_key[0][warp] = c_key[2][warp] = -1;
    __syncwarp();
    // join the slots: the slice's first row, begun before e0, becomes the
    // warp's head; a row going on past e1, its tail; the rest are stored
    if (slot == 0 && active) {
      join_parts<FIXED, VW>(
          ep, s_key, s_key + 32, s_key + 64, s_head + cgl * VW, s_tail + cgl * VW,
          lanes * VW, [&](int lr, bool first, const uint32_t (&sum)[VW], bool goes_on) {
            if (first || goes_on) {
              const int at = first ? 0 : 2;
              uint32_t* dst = (first ? c_head[warp] : c_tail[warp]) + cgl * VW;
#pragma unroll
              for (int i = 0; i < VW; ++i) dst[i] = sum[i];
              if (cgl == 0) {
                c_key[at][warp] = s_row[lr];
                if (first) c_key[1][warp] = goes_on;
              }
            } else {
              store_vec<VW>(xp + (int64_t)s_row[lr] * k + c0, sum);
            }
          });
    }
    __syncthreads();
    // join the warps: a row begun before the chunk goes to carry, the rest to xp
    if (warp == 0 && slot == 0 && active) {
      join_parts<FIXED, VW>(
          kWarps, c_key[0], c_key[1], c_key[2], &c_head[0][cgl * VW], &c_tail[0][cgl * VW],
          32 * 4, [&](int row, bool first, const uint32_t (&sum)[VW], bool) {
            uint32_t* dst = first ? carry + (int64_t)blockIdx.x * k : xp + (int64_t)row * k;
            store_vec<VW>(dst + c0, sum);
          });
    }
    __syncthreads();
  }
}

// x += the continuation partials of row r (edges [rs, re)): carry[j] for
// every chunk j (kWarps slices) that starts strictly inside the row, in
// increasing j.
template <bool FIXED, int VW>
__device__ __forceinline__ void close_row(const uint32_t* __restrict__ carry, int rs,
                                          int re, int chunk_edges, int k, int c0,
                                          uint32_t (&x)[VW]) {
#pragma unroll 4
  for (int64_t j = rs / chunk_edges + 1; j * chunk_edges < re; ++j) {
    uint32_t c[VW];
    ldg_vec<VW>(carry + j * k + c0, c);
#pragma unroll
    for (int i = 0; i < VW; ++i) x[i] = add<FIXED>(x[i], c[i]);
  }
}

// Called by n CTAs of the grid: true in the one that arrives last, which
// sees the global writes every one of them made before the call.  The
// ticket wraps back to 0.  As in a cooperative grid sync, the barrier
// orders the CTA's writes before its first thread's fence and atomic.
__device__ __forceinline__ bool last_cta(unsigned int* ticket, unsigned int n) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicInc(ticket, n - 1) == n - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  return s_last;
}

// out[c] = fold over j < n of load(j, c), for c < k, in a fixed order: group
// g of G = blockDim / min(k, blockDim) threads folds rows g, g + G, ..., then
// the groups fold in order.  Columns in [max_lo, max_hi) take the max of
// non-negative float32 bits (their uint32 order); the rest add<FIXED>.  Every
// thread of the CTA calls it; scratch holds blockDim words.
template <bool FIXED, class Load>
__device__ void fold_rows(Load load, int n, int k, uint32_t* out, uint32_t* scratch,
                          int max_lo = 0, int max_hi = 0) {
  const int t = threadIdx.x;
  const int cp = min(k, (int)blockDim.x);
  const int groups = blockDim.x / cp;
  const int g = t / cp;
  for (int c0 = 0; c0 < k; c0 += cp) {
    const int c = c0 + t % cp;
    const bool is_max = c >= max_lo && c < max_hi;
    uint32_t acc = 0u;
    if (g < groups && c < k) {
#pragma unroll 8
      for (int j = g; j < n; j += groups) {
        const uint32_t x = load(j, c);
        acc = is_max ? max(acc, x) : add<FIXED>(acc, x);
      }
    }
    scratch[t] = acc;
    __syncthreads();
    if (t < cp && c < k) {
      uint32_t tot = 0u;
      for (int gg = 0; gg < groups; ++gg) {
        const uint32_t x = scratch[gg * cp + t];
        tot = is_max ? max(tot, x) : add<FIXED>(tot, x);
      }
      out[c] = tot;
    }
    __syncthreads();
  }
}

// dm_part[blockIdx.x] = Σ P[dang_idx[j]] over this CTA's share of dang_idx,
// for the first n_part CTAs (the others return at once); the last of them
// folds the n_part partials into dm[k].  Float sums run in a fixed order;
// uint32 ones wrap.
template <bool FIXED>
__device__ void dangling_mass_cta(const uint32_t* __restrict__ p,
                                  const int32_t* __restrict__ dang_idx, int n_dang,
                                  int per_cta, int n_part, int k,
                                  uint32_t* __restrict__ dm_part,
                                  uint32_t* __restrict__ dm, unsigned int* ticket,
                                  uint32_t* scratch) {
  if ((int)blockIdx.x >= n_part) return;      // CTA-uniform
  const int lo = blockIdx.x * per_cta;
  const int cnt = max(0, min(per_cta, n_dang - lo));
  fold_rows<FIXED>(
      [&](int j, int c) { return __ldg(p + (int64_t)__ldg(dang_idx + lo + j) * k + c); },
      cnt, k, dm_part + (int64_t)blockIdx.x * k, scratch);
  if (last_cta(ticket, n_part)) {
    fold_rows<FIXED>([&](int j, int c) { return __ldcg(dm_part + (int64_t)j * k + c); },
                     n_part, k, dm, scratch);
  }
}

}  // namespace dst_stream
