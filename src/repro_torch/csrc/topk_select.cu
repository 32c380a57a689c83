// Top-K selection over the final PPR state: for every column j of P [V, κ],
// the n entries with the highest keys, ties to the lower vertex id, with
// exclude[j] deleted — what ppr_serving/topk.py's plain version computes by
// a stable sort of every column.
//
// Replaces no TPU kernel: the reference ranks with XLA's lax.top_k
// (src/repro/ppr_serving/topk.py).  It was added because the sort path
// (every [κ, V] row stable-sorted in full on int64 keys, then sorted again
// for the exclusion) took 2.7 ms of a 12.1 ms wave at 2^20 vertices, and
// 0.33-0.63 ms of a ~1.4 ms wave at 2e5, for work that reads P once.
//
// Bound on the H100: bytes — P read once from HBM (V·κ·4 B: 64 MB at 2^20
// vertices and κ = 16, 0.020 ms at 3.35 TB/s) and κ·n ids and scores
// written.  For n <= kTopkMax one launch, one pass over P, nothing synchronised
// on the host:
//   1. G CTAs (kCtasPerSm an SM) walk tiles of R rows of kSelectWarps
//      columns (grid.y covers κ); a CTA stages its tile in shared memory
//      with coalesced loads, the next tile's loads in flight in registers
//      while its warps scan this one;
//   2. a warp owns one column of the tile and keeps a queue of its best
//      32·NS >= n (key, id) pairs, one a lane and slot, sorted by key desc,
//      id asc.  The lanes test 32 rows at a time against the queue's n-th
//      entry (the bar); a ballot collects the few that pass and shuffles
//      insert each.  The bar is the n-th best of every row of the column the
//      warp has seen, so after the first tiles almost every entry fails one
//      compare;
//   3. each CTA writes its n best a column to scratch [κ, n, G], rank
//      major; the last CTA to arrive (a ticket that wraps back to 0, as
//      kernels A and B count) merges the candidates of each column the same
//      way, a rank of every CTA at a time, and stops at the first rank in
//      which none passes the bar: each CTA's list is sorted, so no deeper
//      entry can.  It writes the ids and the scores read back from P.
// A k above kTopkMax is selected in passes of at most kTopkMax entries, one
// launch each: a pass starts from the last entry the one before it wrote
// (read on the card, from the output) and offers only entries that rank
// after it, so the passes' lists join into the top k.  Each pass reads P
// once again.
// Tried on the H100 and dropped, none faster end to end: a ring of cp.async
// stages, a bar shared across CTAs through atomics, a bitonic merge of a
// ballot's passing lanes, and a floor that a warp's first tile and the merge
// took from the lanes' maxima (0.004-0.009 ms off a call; queries_per_s
// moved by less than its spread).
// Keys: int32 raw Qm.f bits compare as uint32; float32 bits map to a uint32
// whose order is the float order, with -0.0 equal to +0.0 and every NaN
// above +inf and equal to the others, as torch.sort orders them.  Ids are
// unique, so the order is total and the result does not depend on the order
// rows are visited.  The excluded vertex is skipped while scanning:
// deleting it from the top n + 1 leaves exactly the top n of the others.
#include <cstdint>
#include <cuda_runtime.h>

#include "dst_stream.cuh"

namespace {

constexpr int kTopkMax = 64;       // KMAX, the most entries a pass selects a column
constexpr int kSelectWarps = 16;   // warps, and columns, a CTA
constexpr int kPrefetch = 8;       // P words a thread loads a tile
constexpr int kCtasPerSm = 2;      // the grid: this many CTAs an SM
// (the four above are read by kernels/topk_select.py)
constexpr int kSelectThreads = 32 * kSelectWarps;
static_assert(kTopkMax == 64, "a queue holds kTopkMax entries in two slots a lane");
constexpr int kMergeLoads = 4;          // candidates a lane loads at once in the merge
// a tile is kPrefetch load passes of kSelectThreads / width rows at a row
// stride of width | 1 words: at most kPrefetch · 768 words (width 2 .. 16)
constexpr int kTileWords = kPrefetch * (kSelectThreads + kSelectThreads / 2);
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoId = 0x7fffffffu;   // a free slot: ranks after every vertex

template <bool FLOAT>
__device__ __forceinline__ uint32_t rank_key(uint32_t b) {
  if (!FLOAT) return b;
  if ((b & 0x7fffffffu) > 0x7f800000u) return kFull;   // NaN
  if (b == 0x80000000u) b = 0u;                         // -0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (ak, ai) ranks before (bk, bi): the higher key, then the lower id
__device__ __forceinline__ bool before(uint32_t ak, uint32_t ai, uint32_t bk, uint32_t bi) {
  return ak > bk || (ak == bk && ai < bi);
}

// One column's best entries, held by a warp: entry q·32 + lane in slot q of
// that lane, sorted; (tk, ti) is entry n − 1 in every lane, the bar a
// candidate has to pass.  NS slots hold n <= 32·NS: entries past n never
// rank before a candidate that passes the bar, so no more are kept.
template <int NS>
struct Queue {
  uint32_t key[NS], id[NS];
  uint32_t tk, ti;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      key[q] = 0u;
      id[q] = kNoId;
    }
    tk = 0u;
    ti = kNoId;
  }

  // Insert (ck, ci), the same in every lane: the entries that rank before it
  // stay, the rest move up one place.  Called by the whole warp.
  __device__ __forceinline__ void insert(uint32_t ck, uint32_t ci, int n, int lane) {
    if (!before(ck, ci, tk, ti)) return;
    int pos = 0;
#pragma unroll
    for (int q = 0; q < NS; ++q)
      pos += __popc(__ballot_sync(kFull, before(key[q], id[q], ck, ci)));
    uint32_t carry_k = 0u, carry_i = kNoId;   // lane 31 of the slot below
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      uint32_t up_k = __shfl_up_sync(kFull, key[q], 1);
      uint32_t up_i = __shfl_up_sync(kFull, id[q], 1);
      const uint32_t top_k = __shfl_sync(kFull, key[q], 31);
      const uint32_t top_i = __shfl_sync(kFull, id[q], 31);
      if (lane == 0) {
        up_k = carry_k;
        up_i = carry_i;
      }
      carry_k = top_k;
      carry_i = top_i;
      const int i = q * 32 + lane;
      if (i == pos) {
        key[q] = ck;
        id[q] = ci;
      } else if (i > pos) {
        key[q] = up_k;
        id[q] = up_i;
      }
    }
    const int bar_q = (n - 1) >> 5;
    uint32_t bk = key[0], bi = id[0];
#pragma unroll
    for (int q = 1; q < NS; ++q)
      if (q == bar_q) {
        bk = key[q];
        bi = id[q];
      }
    tk = __shfl_sync(kFull, bk, (n - 1) & 31);
    ti = __shfl_sync(kFull, bi, (n - 1) & 31);
  }

  // Offer each lane's (k, i) where `ok`, in lane order; whether any passed
  // the bar.  Called by the whole warp.
  __device__ __forceinline__ bool offer(uint32_t k, uint32_t i, bool ok, int n, int lane) {
    unsigned m = __ballot_sync(kFull, ok && before(k, i, tk, ti));
    const bool hit = m != 0u;
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(kFull, k, src), __shfl_sync(kFull, i, src), n, lane);
    }
    return hit;
  }
};

// NS: queue slots a lane (n <= 32·NS).  The pass writes entries
// [offset, offset + n) of each output row of out_stride; after the first it
// offers only entries that rank after entry offset − 1 there.
template <bool FLOAT, int NS>
__global__ void __launch_bounds__(kSelectThreads, kCtasPerSm)
topk_select_kernel(const uint32_t* __restrict__ p, const int32_t* __restrict__ exclude,
                   int n_rows, int kappa, int n, int offset, int out_stride,
                   uint32_t* __restrict__ cand_key, uint32_t* __restrict__ cand_id,
                   int32_t* __restrict__ out_id, uint32_t* __restrict__ out_val,
                   unsigned int* tickets) {
  __shared__ uint32_t tile[kTileWords];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g0 = blockIdx.y * kSelectWarps;         // the CTA's first column
  const int width = min(kSelectWarps, kappa - g0);  // and its number
  const int layout = min(kSelectWarps, kappa);      // the tile's width in every CTA
  const int stride = layout | 1;                    // odd: a column's 32 rows hit 32 banks
  const int rpp = kSelectThreads / layout;          // rows a load pass
  const int tile_rows = kPrefetch * rpp;
  const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const int lc = t % layout, lr = t / layout;       // this thread's column and row in a pass
  const bool loader = lr < rpp && lc < width;
  const int col = g0 + warp;                        // the warp's column, if warp < width
  const int grid = gridDim.x;
  const int64_t out = (int64_t)col * out_stride + offset;

  Queue<NS> q;
  q.reset();
  const uint32_t ex = (exclude != nullptr && warp < width) ? (uint32_t)exclude[col] : kFull;
  // the last entry the previous pass selected: an entry has to rank after it
  const bool after = offset > 0 && warp < width;
  const uint32_t sk = after ? rank_key<FLOAT>(out_val[out - 1]) : 0u;
  const uint32_t si = after ? (uint32_t)out_id[out - 1] : 0u;

  uint32_t buf[kPrefetch];
  auto load = [&](int tile_idx) {
    const int64_t r0 = (int64_t)tile_idx * tile_rows + lr;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int64_t r = r0 + (int64_t)i * rpp;
      buf[i] = (loader && r < n_rows) ? __ldg(p + r * kappa + g0 + lc) : 0u;
    }
  };
  if ((int)blockIdx.x < n_tiles) load(blockIdx.x);
  for (int tile_idx = blockIdx.x; tile_idx < n_tiles; tile_idx += grid) {
    __syncthreads();                      // the warps are done with the last tile
    if (loader) {
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) tile[(lr + i * rpp) * stride + lc] = buf[i];
    }
    __syncthreads();
    if (tile_idx + grid < n_tiles) load(tile_idx + grid);
    if (warp >= width) continue;          // warp-uniform
    const int row0 = tile_idx * tile_rows;
    const int rows = min(tile_rows, n_rows - row0);
    for (int r = lane; r - lane < rows; r += 32) {
      const bool ok = r < rows;
      const uint32_t key = ok ? rank_key<FLOAT>(tile[r * stride + warp]) : 0u;
      const uint32_t id = (uint32_t)(row0 + r);
      q.offer(key, id, ok && id != ex && (!after || before(sk, si, key, id)), n, lane);
    }
  }

  // this CTA's n best (rank i at [col, i, CTA]), then the last CTA merges them
  if (warp < width) {
    const int64_t base = (int64_t)col * n * grid + blockIdx.x;
#pragma unroll
    for (int qs = 0; qs < NS; ++qs) {
      const int i = qs * 32 + lane;
      if (i < n) {
        cand_key[base + (int64_t)i * grid] = q.key[qs];
        cand_id[base + (int64_t)i * grid] = q.id[qs];
      }
    }
  }
  if (!dst_stream::last_cta(tickets + blockIdx.y, grid) || warp >= width) return;

  q.reset();
  for (int rank = 0; rank < n; ++rank) {
    const int64_t base = ((int64_t)col * n + rank) * grid;
    bool hit = false;
    for (int j0 = 0; j0 < grid; j0 += 32 * kMergeLoads) {
      uint32_t ck[kMergeLoads], ci[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        const int j = j0 + u * 32 + lane;
        ck[u] = j < grid ? __ldcg(cand_key + base + j) : 0u;
        ci[u] = j < grid ? __ldcg(cand_id + base + j) : kNoId;
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) hit |= q.offer(ck[u], ci[u], true, n, lane);
    }
    if (!hit) break;                      // warp-uniform: no deeper rank can pass
  }
#pragma unroll
  for (int qs = 0; qs < NS; ++qs) {
    const int i = qs * 32 + lane;
    if (i < n) {
      const uint32_t id = q.id[qs];
      out_id[out + i] = (int32_t)id;
      out_val[out + i] = id < (uint32_t)n_rows ? p[(int64_t)id * kappa + col] : 0u;
    }
  }
}

template <bool FLOAT, int NS>
void launch(const void* p, const void* exclude, int n_rows, int kappa, int n, int offset,
            int out_stride, int grid, void* cand, void* out_id, void* out_val, void* tickets,
            cudaStream_t s) {
  uint32_t* cand_key = static_cast<uint32_t*>(cand);
  const dim3 blocks(grid, (kappa + kSelectWarps - 1) / kSelectWarps);
  topk_select_kernel<FLOAT, NS><<<blocks, kSelectThreads, 0, s>>>(
      static_cast<const uint32_t*>(p), static_cast<const int32_t*>(exclude), n_rows, kappa,
      n, offset, out_stride, cand_key, cand_key + (int64_t)kappa * grid * n,
      static_cast<int32_t*>(out_id), static_cast<uint32_t*>(out_val),
      static_cast<unsigned int*>(tickets));
}

}  // namespace

extern "C" {

// One pass: entries [offset, offset + n) of the ranking of every column of
// p [n_rows, κ] (float32 when is_float, else raw uint32 bits), exclude[j]
// deleted (exclude: κ int32, or null), into row j of ids [κ, out_stride]
// int32 and scores [κ, out_stride] (P's raw 4-byte words); a pass with
// offset > 0 reads entry offset − 1 there, which the pass before wrote.
// 1 <= n <= kTopkMax; offset + n <= out_stride; grid CTAs a column group;
// cand: 2·κ·grid·n words of scratch; tickets: ceil(κ / kSelectWarps) zeroed
// words, left zeroed.  Returns cudaGetLastError().
int topk_select_launch(const void* p, const void* exclude, int n_rows, int kappa, int n,
                       int offset, int out_stride, int grid, void* cand, void* out_id,
                       void* out_val, void* tickets, int is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  auto fn = is_float ? (n <= 32 ? &launch<true, 1> : &launch<true, 2>)
                     : (n <= 32 ? &launch<false, 1> : &launch<false, 2>);
  fn(p, exclude, n_rows, kappa, n, offset, out_stride, grid, cand, out_id, out_val, tickets,
     s);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_select_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
