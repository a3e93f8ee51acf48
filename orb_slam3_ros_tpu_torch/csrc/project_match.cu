// Projection-guided descriptor matching (best / second-best / mutual) for
// Hopper (sm_90a), in one kernel launch per search.
//
// Replaces: orb_slam3_ros_tpu/ops/pallas_match.py::_kernel (reached through
// project_match_best2), the JAX package's one Pallas kernel. It computes the
// contract of the dense XLA path that the Pallas kernel stands in for
// (hamming.masked_best2 + hamming.mutual_nn as called by
// matching.search_by_projection), ties included:
//   * a candidate (p, n) counts only if both are valid, |level_n - level_p|
//     <= level_slack, and d2 = (u_p - x_n)^2 + (v_p - y_n)^2 <= r_p^2, with
//     d2 rounded as the torch ops round it (__fsub_rn / __fmul_rn /
//     __fadd_rn, no FMA contraction);
//   * the distance is the +-1 dot product over the int8 signs, (256 - dot)
//     >> 1 with __dp4a: exact for signs in {-1, 0, +1}, which give 0..256
//     (an all-zero row gives 128 as hamming_matrix does). Other int8 values
//     are outside the contract: their distances can leave 0..998 and spill
//     into the index bits of the packed words;
//   * best = the minimum masked distance of row p, idx = its lowest column;
//     second = the minimum over the other columns (a tie with the best gives
//     second == best, unlike the Pallas kernel, which dropped in-chunk ties);
//   * col_word[n] = min over rows of (dist << 20) | p, so its low 20 bits
//     are the lowest row achieving the column minimum (the argmin the
//     mutual check of mutual_nn reads). Atomic minima of such words do not
//     depend on the order of the atomics;
//   * row p keeps its match only if best <= max_dist, best <= ratio * second
//     (in float32, as the torch ops round it) and p is its column's best
//     row; (match_idx, match_dist) are -1 / 999 elsewhere, as
//     search_by_projection returns them.
//
// What bounds it on an H100. Each input read once and each output written
// once is 273 B a landmark row, 269 B a feature and 8 B of output a row:
// 0.49 MB at the tracking shape (768 x 1032), 1.43 MB at the fusion shape
// (4096 x 1032), that is 0.147 us and 0.43 us at 3.35 TB/s; the dense
// product (0.41 GOP at the tracking shape) would take 0.2 us at the int8
// tensor-core rate, and only the pairs inside a search window need a
// distance at all (3% of them at tracking's 60 px radius, one in 1500 at
// fusion's 3 px). So memory bounds it on paper, at a tenth of what an empty
// launch costs: the kernel is bound by latency, by the chain of dependent
// trips to L2 each block makes (stage the geometry, fetch candidate rows,
// merge, fence, ticket, and the last block's finish), not by bandwidth or
// arithmetic. The design removes launches and serial trips, not bytes.
// Times, the phase profile and the variants that lost are in PERF.md.
//
// Design against that:
//   1. One launch a search, nothing allocated but the output. The wrapper
//      keeps a persistent workspace (a ticket, one word a column, two words
//      a row) that init_workspace fills once. Every block merges its rows'
//      state into the row words with atomicMin, fences, and takes a ticket;
//      the block that draws the last ticket applies max_dist / ratio /
//      mutual to every row (kTailRows rows a thread at a time, so their
//      loads overlap), writes the outputs and resets the words and the
//      ticket: the next call finds the workspace as this one did.
//   2. Fill the card. The grid is (ceil(P / 8), S): the feature columns are
//      cut into S contiguous ranges (multiples of 32) so that at least
//      kTargetBlocks blocks exist whatever P is; S is chosen here from P
//      and N (5 at the tracking shape, 1 at the fusion shape). More blocks
//      than that cost more in fixed per-block trips than they win.
//   3. Stage the geometry, fetch only candidates. A block stages x (with
//      validity folded in as +inf), y and level of its column range in
//      shared memory once. The 256-byte sign rows are not staged: only
//      candidates need them, so the warp reads each candidate's row
//      straight from L2 (8 B a lane, one coalesced 256-byte request),
//      kInFlight rows requested before the first is reduced. Staging every
//      feature row with 16-byte cp.async in two stages moves
//      ceil(P / 8) * N * 256 B through L2 to use a few per cent of it and
//      was measured slower at two shapes of three, and dropped.
//   4. Warp-cooperative distances over compacted candidates. One warp owns
//      one landmark row and keeps the row's 64 sign words in registers, two
//      a lane. Each lane tests the window of one feature; __ballot_sync
//      and a prefix popcount append the group's candidates to the warp's
//      list in ascending order; then the whole warp computes one distance
//      at a time (two __dp4a a lane, one __reduce_add_sync) and lane 0
//      sends the column atomicMin. No lane waits on another lane's loop.
//   5. Warp-uniform running state. (best, second, idx) is the same in every
//      lane and sees columns in ascending order, so strict < is the tie
//      rule within a range. Across ranges a row's word 0 is the atomic
//      minimum of the ranges' (best << 20) | column words, so an equal best
//      keeps the lower column, and word 1 the minimum of every word that
//      lost against word 0 and of the ranges' seconds: the overall least
//      word never loses and the second least loses exactly once, so the
//      result does not depend on the order of the atomics
//      (project_match_reference_split is this rule in plain torch).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kInvalid = 999;
constexpr int kRowsPerBlock = 8;  // one warp per landmark row
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kGeomTile = 1056;    // features whose geometry is staged at once (33 groups of 32)
constexpr int kTargetBlocks = 396; // 3 blocks of 8 warps on each of 132 SMs
constexpr int kInFlight = 8;       // candidate rows requested before the first is used
constexpr int kListCap = 128;      // a warp's candidate list; at least 32 + one group
constexpr int kTailRows = 4;       // rows a tail thread finishes at once
constexpr int kIdxBits = 20;       // row bits of a column word, column bits of a row word
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kColInit = kInvalid << kIdxBits;  // a column no row has claimed: row 0
constexpr int kRowInit = kColInit | kIdxMask;   // a row without a candidate
constexpr int kHeader = 4;  // ticket, padded so the words after it stay 16-byte aligned
constexpr unsigned kFull = 0xffffffffu;

__global__ void empty_kernel() {}

// Workspace: [ticket, 0, 0, 0 | col_word[N], padded to 4 | row_word[P][2]].
__host__ __device__ inline int col_words(int N) { return (N + 3) & ~3; }

__global__ void init_workspace(int* ws, int P, int N) {
  int n_col = col_words(N);
  int total = kHeader + n_col + 2 * P;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x)
    ws[i] = i < kHeader ? 0 : i < kHeader + n_col ? kColInit : kRowInit;
}

// Feature columns per split: a multiple of 32, so that about kTargetBlocks
// blocks exist.
int split_cols(int P, int N) {
  int row_blocks = (P + kRowsPerBlock - 1) / kRowsPerBlock;
  int want = (kTargetBlocks + row_blocks - 1) / row_blocks;
  int groups = (N + 31) / 32;
  return 32 * ((groups + want - 1) / want);
}

__global__ void __launch_bounds__(kThreads)
project_match_kernel(const float* __restrict__ proj_uv,
                     const uint8_t* __restrict__ proj_valid,
                     const int* __restrict__ proj_level,
                     const int2* __restrict__ proj_sign,  // [P, 32] word pairs
                     const float* __restrict__ radius,
                     const float* __restrict__ feat_xy,
                     const int* __restrict__ feat_level,
                     const uint8_t* __restrict__ feat_valid,
                     const int2* __restrict__ feat_sign,  // [N, 32] word pairs
                     int P, int N, int level_slack, int cols, int max_dist,
                     float ratio, int* __restrict__ ws,
                     int* __restrict__ match_idx, int* __restrict__ match_dist) {
  // x (+inf where the feature is invalid or the slot is padding), y, level.
  __shared__ float4 s_geom[kGeomTile];
  __shared__ unsigned short s_cand[kRowsPerBlock][kListCap];
  __shared__ bool s_last;

  int* ticket = ws;
  int* col_word = ws + kHeader;
  int2* row_word = reinterpret_cast<int2*>(col_word + col_words(N));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kRowsPerBlock + warp;
  // Every load of the row starts at once (a dead warp reads row P - 1).
  const int pl = min(p, P - 1);
  const bool pvalid = p < P && proj_valid[pl] != 0;
  const float u = proj_uv[2 * pl];
  const float v = proj_uv[2 * pl + 1];
  const float r = radius[pl];
  const float r2 = pvalid ? __fmul_rn(r, r) : -1.f;
  const int lvl_lo = proj_level[pl] - level_slack;
  const unsigned lvl_span = 2u * level_slack;
  const int2 row = proj_sign[(size_t)pl * 32 + lane];
  const int c0 = blockIdx.y * cols;
  const int c1 = min(c0 + cols, N);

  // Warp-uniform running state over ascending columns.
  int best = kInvalid, second = kInvalid, idx = 0;

  // The distances of the listed candidates s_cand[warp][0 .. count), one at
  // a time by the whole warp, kInFlight sign rows requested before the
  // first is reduced.
  auto drain = [&](int base, int count) {
    __syncwarp();
    for (int i = 0; i < count; i += kInFlight) {
      int n[kInFlight];
      int2 w[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        n[k] = -1;
        w[k] = make_int2(0, 0);
        if (i + k < count) {
          n[k] = base + s_cand[warp][i + k];
          w[k] = __ldg(feat_sign + (size_t)n[k] * 32 + lane);
        }
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (n[k] < 0) break;
        int dot = __dp4a(row.x, w[k].x, 0);
        dot = __dp4a(row.y, w[k].y, dot);
        dot = __reduce_add_sync(kFull, dot);
        int d = (256 - dot) >> 1;
        // Strict <: the lowest column keeps a tied best, and the tie
        // becomes the second.
        if (d < best) {
          second = best;
          best = d;
          idx = n[k];
        } else if (d < second) {
          second = d;
        }
        if (lane == 0) atomicMin(col_word + n[k], (d << kIdxBits) | p);
      }
    }
    __syncwarp();
  };

  for (int base = c0; base < c1; base += kGeomTile) {
    const int n_tile = min(kGeomTile, c1 - base);
    const int n_pad = (n_tile + 31) & ~31;
    if (base != c0) __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < n_pad; i += kThreads) {
      int n = min(base + i, N - 1);
      // An invalid feature sits at x = +inf, outside every window.
      bool live = i < n_tile && feat_valid[n] != 0;
      s_geom[i] = make_float4(live ? feat_xy[2 * n] : CUDART_INF_F, feat_xy[2 * n + 1],
                              __int_as_float(feat_level[n]), 0.f);
    }
    __syncthreads();
    if (!pvalid) continue;

    // Each lane tests one feature's window; the group's candidates join the
    // warp's list in ascending order; a list that could overflow is drained
    // first.
    int count = 0;
    for (int g = 0; g < n_pad; g += 32) {
      const float4 q = s_geom[g + lane];
      float dx = __fsub_rn(u, q.x);
      float dy = __fsub_rn(v, q.y);
      float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      bool ok = d2 <= r2 && (unsigned)(__float_as_int(q.z) - lvl_lo) <= lvl_span;
      unsigned bits = __ballot_sync(kFull, ok);
      if (bits == 0) continue;
      if (count + 32 > kListCap) {
        drain(base, count);
        count = 0;
      }
      if (ok) s_cand[warp][count + __popc(bits & ((1u << lane) - 1))] = g + lane;
      count += __popc(bits);
    }
    drain(base, count);
  }

  // Merge this split's state into the row's two words: word 0 ends as the
  // least (dist, column) word of all splits, word 1 as the least of every
  // word that lost to it and every split's second, whatever the order of
  // the atomics (the overall least word is never a loser; the second least
  // loses exactly once).
  if (lane == 0 && best < kInvalid) {
    int* rw = reinterpret_cast<int*>(row_word + p);
    int bw = (best << kIdxBits) | idx;
    int old = atomicMin(rw, bw);
    atomicMin(rw + 1, max(old, bw));
    if (second < kInvalid) atomicMin(rw + 1, (second << kIdxBits) | kIdxMask);
  }

  // The block that draws the last ticket sees every block's atomics (fence
  // before the ticket, fence after it) and finishes all rows.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = gridDim.x * gridDim.y;
    s_last = atomicAdd(reinterpret_cast<unsigned*>(ticket), 1u) == total - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q0 = threadIdx.x; q0 < P; q0 += kTailRows * kThreads) {
    int2 rw[kTailRows];
    int cw[kTailRows];
#pragma unroll
    for (int k = 0; k < kTailRows; ++k) {
      int q = q0 + k * kThreads;
      rw[k] = q < P ? __ldcg(row_word + q) : make_int2(kRowInit, kRowInit);
    }
#pragma unroll
    for (int k = 0; k < kTailRows; ++k) {
      // A row without a candidate reads column 0, as argmin over an empty
      // row does.
      int i = (rw[k].x >> kIdxBits) < kInvalid ? (rw[k].x & kIdxMask) : 0;
      cw[k] = __ldcg(col_word + i);
      rw[k].x = (rw[k].x & ~kIdxMask) | i;
    }
#pragma unroll
    for (int k = 0; k < kTailRows; ++k) {
      int q = q0 + k * kThreads;
      if (q >= P) break;
      int b = rw[k].x >> kIdxBits, s = rw[k].y >> kIdxBits;
      bool ok = b <= max_dist &&
                __int2float_rn(b) <= __fmul_rn(ratio, __int2float_rn(s)) &&
                (cw[k] & kIdxMask) == q;
      match_idx[q] = ok ? (rw[k].x & kIdxMask) : -1;
      match_dist[q] = ok ? b : kInvalid;
      row_word[q] = make_int2(kRowInit, kRowInit);
    }
  }
  __syncthreads();  // every mutual check has read its column word
  for (int n = threadIdx.x; n < N; n += kThreads) col_word[n] = kColInit;
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace

// Kernel launches this library has queued since it was loaded: every
// launch in this file is followed by one count, so a caller reads what a
// call queued as the difference around it.
static std::atomic<int> g_launches_queued{0};

extern "C" int project_match_launches_queued() { return g_launches_queued.load(); }

// int32 words of workspace a search of P rows and N features needs. The
// caller allocates it once, has project_match_init_workspace fill it, and
// hands the same buffer to every later call of that shape on that stream:
// each call leaves it as it found it.
extern "C" int project_match_workspace_ints(int P, int N) {
  return kHeader + col_words(N) + 2 * P;
}

extern "C" int project_match_init_workspace(void* workspace, int P, int N,
                                            void* stream) {
  init_workspace<<<32, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(workspace), P, N);
  ++g_launches_queued;
  return static_cast<int>(cudaGetLastError());
}

// Feature columns per split of the grid's second dimension (boundaries lie
// at its multiples).
extern "C" int project_match_split_cols(int P, int N) { return split_cols(P, N); }

// Queues a kernel that does nothing: the floor of any launch's time.
extern "C" int project_match_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  ++g_launches_queued;
  return static_cast<int>(cudaGetLastError());
}

// The search of matching.search_by_projection: match_idx / match_dist [P]
// int32. Returns cudaGetLastError() after queueing the kernel on `stream`.
extern "C" int project_match(
    const void* proj_uv, const void* proj_valid, const void* proj_level,
    const void* proj_sign, const void* radius, const void* feat_xy,
    const void* feat_level, const void* feat_valid, const void* feat_sign,
    int P, int N, int level_slack, int max_dist, float ratio, void* workspace,
    void* match_idx, void* match_dist, void* stream) {
  if (P <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int cols = split_cols(P, N);
  dim3 grid((P + kRowsPerBlock - 1) / kRowsPerBlock, (N + cols - 1) / cols);
  project_match_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proj_uv),
      static_cast<const uint8_t*>(proj_valid),
      static_cast<const int*>(proj_level),
      static_cast<const int2*>(proj_sign), static_cast<const float*>(radius),
      static_cast<const float*>(feat_xy), static_cast<const int*>(feat_level),
      static_cast<const uint8_t*>(feat_valid),
      static_cast<const int2*>(feat_sign), P, N, level_slack, cols, max_dist,
      ratio, static_cast<int*>(workspace), static_cast<int*>(match_idx),
      static_cast<int*>(match_dist));
  ++g_launches_queued;
  return static_cast<int>(cudaGetLastError());
}
