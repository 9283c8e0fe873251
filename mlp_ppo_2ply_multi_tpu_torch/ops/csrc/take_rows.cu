// take_rows: a per-game row take, out[n, k] = boards[n, idx[n, k]].
//
// Replaces the three TPU kernels of scripts/probe_pallas_batched_dot.py that
// compute this function: take_pallas (:55, a one-hot bf16 [R, K, W] built
// outside the kernel, then a batched dot or a loop of 2-D dots), take_pallas_fused
// (:86, the one-hot built inside the kernel) and take_bdiag (:214, r games as
// one block-diagonal one-hot product). They are ways to make the TPU's matrix
// unit do a take. Here the same function is a byte gather. The port's sorted
// move generator (engine/movegen.py) runs it for its first-ply, parent and
// forced-shorter takes.
//
// Contract: boards int8 [N, W, C] with C a multiple of 4, idx int32 or int64
// [N, K], out int8 [N, K, C], all contiguous and 4-byte aligned. An index
// outside [0, W) gives a zero row (the one-hot of P1/P2 with no match); the
// kernel never reads outside game n's table.
//
// Bound: bytes. It does no arithmetic beyond addresses: the source rows used,
// the indices and N * K * C bytes written. A thread a 32-bit output word
// (the first design) paid two integer divisions, an index load and a 4-byte
// load and store a word, and reached 38.5% of that bound.
//
// Design: a CTA takes whole games, so its indices, its sources and its output
// are each one contiguous run, and it writes its output with 16-byte stores by
// consecutive threads (4-byte stores where K * C is not a multiple of 16).
// No division runs in a loop: each thread walks (row, word) by a fixed step.
// Two branches, picked on the host from the shapes (take_rows_plan):
// * staged: when a game's table is at most twice the rows taken and fits in
//   shared memory, the tables of the CTA's games (one or, for small ones, a
//   few games) are copied in with cp.async, 16 bytes at a time when W * C is
//   a multiple of 16 and 4 bytes otherwise, while the indices become word
//   offsets into them; the output is then assembled from shared memory.
//   It reads each table once, whole: at K = W about 1.6 times the used rows.
// * gather: otherwise (a table much wider than the rows taken, as the
//   actor's [96 from 448], or over the budget) one game a CTA copies its used
//   rows with 4-byte cp.async straight into an output tile in shared memory,
//   tile by tile, and stores each tile with 16-byte stores.
// C = 52 (13 words) is compiled as a constant; any other C takes the generic
// instance of the same code.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// dynamic shared memory a CTA uses, below the 48 KB that needs no opt-in
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxGames = 32;
// the staged branch gives a CTA games until its output reaches this
constexpr int kTargetOutBytes = 8 * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// Store `words` output words from shared memory: word i is
// tab[row_at[i / cw] + i % cw], or 0 where row_at is negative.
template <int kCW, bool kVec>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ gout,
                                            const uint32_t* __restrict__ tab,
                                            const int* __restrict__ row_at, int words,
                                            int cw_arg) {
  const int cw = kCW ? kCW : cw_arg;
  constexpr int kPer = kVec ? 4 : 1;  // words a store
  const int first = kPer * static_cast<int>(threadIdx.x);
  int r = first / cw, c = first - r * cw;
  const int sr = (kPer * kThreads) / cw, sc = kPer * kThreads - sr * cw;
  for (int q = threadIdx.x; q < words / kPer; q += kThreads) {
    uint32_t v[kPer];
    int rr = r, cc = c;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int base = row_at[rr];
      v[j] = base < 0 ? 0u : tab[base + cc];
      if (++cc == cw) {
        cc = 0;
        ++rr;
      }
    }
    if constexpr (kVec) {
      reinterpret_cast<uint4*>(gout)[q] = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      gout[q] = v[0];
    }
    r += sr;
    c += sc;
    if (c >= cw) {
      c -= cw;
      ++r;
    }
  }
}

template <typename Index, int kCW, bool kVec>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const uint32_t* __restrict__ boards, const Index* __restrict__ idx,
                 uint32_t* __restrict__ out, int n, int w, int k, int cw_arg, int games,
                 int tile_rows, int staged) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int cw = kCW ? kCW : cw_arg;
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * games;
  const int ng = min(games, n - g0);
  const Index* gidx = idx + static_cast<size_t>(g0) * k;
  const uint32_t* gtab = boards + static_cast<size_t>(g0) * w * cw;
  uint32_t* gout = out + static_cast<size_t>(g0) * k * cw;

  if (staged) {
    // the CTA's tables, then each output row's first word in them
    uint32_t* table = smem;
    int* row_at = reinterpret_cast<int*>(smem + round_up4(games * w * cw));
    const int tw = ng * w * cw;
    if (((w * cw) & 3) == 0 && (reinterpret_cast<uintptr_t>(boards) & 15) == 0) {
      for (int i = tid; i < tw / 4; i += kThreads) cp_async16(table + 4 * i, gtab + 4 * i);
    } else {
      for (int i = tid; i < tw; i += kThreads) cp_async4(table + i, gtab + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int g = 0; g < ng; ++g) {
      for (int j = tid; j < k; j += kThreads) {
        const long long s = static_cast<long long>(__ldg(gidx + g * k + j));
        row_at[g * k + j] = (s >= 0 && s < w) ? (g * w + static_cast<int>(s)) * cw : -1;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    store_words<kCW, kVec>(gout, table, row_at, ng * k * cw, cw);
    return;
  }

  // gather (one game a CTA): tiles of tile_rows output rows, each row's
  // words copied from its source row into the tile, then the tile stored
  uint32_t* tile = smem;
  int* row_at = reinterpret_cast<int*>(smem + tile_rows * cw);
  const int first_r = tid / cw, first_c = tid - first_r * cw;
  const int sr = kThreads / cw, sc = kThreads - sr * cw;
  for (int r0 = 0; r0 < k; r0 += tile_rows) {
    const int tr = min(tile_rows, k - r0);
    for (int j = tid; j < tr; j += kThreads) {
      const long long s = static_cast<long long>(__ldg(gidx + r0 + j));
      row_at[j] = (s >= 0 && s < w) ? static_cast<int>(s) * cw : -1;
    }
    __syncthreads();
    int r = first_r, c = first_c;
    for (int i = tid; i < tr * cw; i += kThreads) {
      const int base = row_at[r];
      if (base >= 0) {
        cp_async4(tile + i, gtab + base + c);
      } else {
        tile[i] = 0u;
      }
      r += sr;
      c += sc;
      if (c >= cw) {
        c -= cw;
        ++r;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t* o = gout + static_cast<size_t>(r0) * cw;
    if constexpr (kVec) {
      for (int q = tid; q < tr * cw / 4; q += kThreads) {
        reinterpret_cast<uint4*>(o)[q] = reinterpret_cast<const uint4*>(tile)[q];
      }
    } else {
      for (int i = tid; i < tr * cw; i += kThreads) o[i] = tile[i];
    }
    __syncthreads();
  }
}

struct Plan {
  int staged, games, tile_rows, smem_bytes;
};

Plan make_plan(long long n, int w, int k, int cw) {
  Plan p{0, 1, 0, 0};
  const long long table_bytes = 4LL * (round_up4(w * cw) + k);
  if (w <= 2 * k && table_bytes <= kSmemBytes) {
    p.staged = 1;
    for (int g = 2; g <= kMaxGames && g <= n; ++g) {
      const long long smem = 4LL * (round_up4(g * w * cw) + static_cast<long long>(g) * k);
      if (smem > kSmemBytes || 4LL * (g - 1) * k * cw >= kTargetOutBytes) break;
      p.games = g;
    }
    p.smem_bytes = 4 * (round_up4(p.games * w * cw) + p.games * k);
  } else {
    // a tile: tile_rows * cw words, then row_at (tile_rows ints)
    const int fit = (kSmemBytes / 4) / (cw + 1) / 4 * 4;
    p.tile_rows = round_up4(k) < fit ? round_up4(k) : fit;
    p.smem_bytes = 4 * p.tile_rows * (cw + 1);
  }
  return p;
}

template <typename Index, int kCW>
int launch_cw(const void* boards, const void* idx, void* out, long long n, int w, int k, int cw,
              const Plan& p, bool vec, cudaStream_t s) {
  const long long blocks = (n + p.games - 1) / p.games;
  const auto* b = static_cast<const uint32_t*>(boards);
  const auto* i = static_cast<const Index*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  const int ni = static_cast<int>(n);
  if (vec) {
    take_rows_kernel<Index, kCW, true><<<static_cast<unsigned>(blocks), kThreads, p.smem_bytes, s>>>(
        b, i, o, ni, w, k, cw, p.games, p.tile_rows, p.staged);
  } else {
    take_rows_kernel<Index, kCW, false><<<static_cast<unsigned>(blocks), kThreads, p.smem_bytes, s>>>(
        b, i, o, ni, w, k, cw, p.games, p.tile_rows, p.staged);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int launch_index(const void* boards, const void* idx, void* out, long long n, int w, int k,
                 int cw, const Plan& p, bool vec, cudaStream_t s) {
  if (cw == 13) return launch_cw<Index, 13>(boards, idx, out, n, w, k, cw, p, vec, s);
  return launch_cw<Index, 0>(boards, idx, out, n, w, k, cw, p, vec, s);
}

}  // namespace

// The branch and sizes a launch of these shapes uses: plan[0] 1 when staged,
// plan[1] games a CTA, plan[2] rows a tile (gather), plan[3] shared memory
// bytes. Returns 0, or cudaErrorInvalidValue when a gather tile cannot hold
// 4 rows (C above ~3 KB).
extern "C" int take_rows_plan(long long n, int w, int k, int cw, int* plan) {
  const Plan p = make_plan(n, w, k, cw);
  plan[0] = p.staged;
  plan[1] = p.games;
  plan[2] = p.tile_rows;
  plan[3] = p.smem_bytes;
  return (!p.staged && p.tile_rows < 4) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Launch on ``stream``: ``n`` games, ``w`` table rows a game, ``k`` output
// rows a game, ``cw`` 32-bit words a row, ``idx_bytes`` 4 (int32) or 8
// (int64). The caller keeps n * k * cw and n * w * cw below 2^31; with W = 0
// every row is a zero row.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int take_rows_launch(const void* boards, const void* idx, int idx_bytes, void* out,
                                long long n, int w, int k, int cw, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const Plan p = make_plan(n, w, k, cw);
  if (!p.staged && p.tile_rows < 4) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<long long>(k) * cw) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) return launch_index<long long>(boards, idx, out, n, w, k, cw, p, vec, s);
  return launch_index<int>(boards, idx, out, n, w, k, cw, p, vec, s);
}
