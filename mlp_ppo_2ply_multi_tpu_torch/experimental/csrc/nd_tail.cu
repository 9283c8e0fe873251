// Fused non-doubles tail for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mlp_ppo_2ply_multi_tpu/experimental/nd_tail.py:137
// (_make_kernel, pallas_call in nd_tail_fused). Per row (one game, or one
// (game, candidate) pair of the 2-ply scorer's reply enumeration) it computes
// the back half of non-doubles move enumeration:
//
//   1. select the first K set cells of the 1512 candidate bits, in order
//      (blocks of 27: pass-A pairs 0..26, pass-A singles 27, pass-B pairs
//      28..54, pass-B singles 55);
//   2. decode each selected cell to (pass, first slot i, second slot j), take
//      the first-ply child i of that pass, and apply the second submove j;
//   3. form the canonical delta signature of the candidate's afterstate;
//   4. drop a candidate whose signature equals an earlier one's
//      (first-occurrence dedup), apply the max-submove filter (if any kept
//      candidate is a 2-submove move, singles go), then the Q7 rank cap.
//
// Outputs: after int8 [n, K, 52], keep and kpair bytes [n, K], n_pre and pct
// int32 [n]. The function is bit-identical to the plain PyTorch version
// (experimental/nd_tail.py::nd_tail_plain): integer arithmetic only. Beyond
// the row's candidate count a slot holds what the plain version's clipped
// select gives (pass-B child 26, keep and kpair 0), so even `after` is
// defined and equal everywhere, though consumers read it only at kept slots.
//
// What bounds it. Per row the function reads 1512 candidate bytes, two child
// tables of 27 x 52 bytes, the 52-byte root and three ints (4,384 B), and
// writes K x 52 + 2K + 8 bytes (5,192 B at K = 96). Its arithmetic is a few
// hundred integer operations per candidate plus K(K-1)/2 signature compares
// per row, ~1 us of the CUDA cores at [4096, 96] against ~12 us for the bytes
// at 3.35 TB/s: bytes bound it.
//
// What the design does about it. One thread block per row, one thread per
// candidate (blockDim = K rounded up to a warp). The row's inputs are staged
// into shared memory with word loads (2,860 B of boards); nothing but the
// outputs goes back to device memory. The select is one block prefix sum:
// each thread counts the set bytes of its chunk of the 1512, and the
// exclusive scan places its set cells into the sorted index list. Each
// candidate thread decodes its cell, builds its afterstate in shared memory
// and writes its signature there; the dedup is a broadcast read of the
// earlier signatures; has_pair is __syncthreads_or and the Q7 rank a second
// block scan. The afterstates leave shared memory in coalesced 4-byte words.
// The Pallas kernel's one-hot matmuls and triangular cumsums, which served
// the TPU's matrix unit, have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 27;
constexpr int kBlocks = 2 * (kSlots + 1);   // 56
constexpr int kCand = kBlocks * kSlots;     // 1512
constexpr int kCells = 52;
constexpr int kChild = kSlots * kCells;     // 1404
constexpr int kPoints = 24;
constexpr int kBar = 24;
constexpr int kOff = 25;
constexpr int kSent = 31;                   // signature lane: absent
constexpr int kMaxK = 576;

struct Submove {
  int start, end;
  bool hit;
};

// Farthest occupied home point (movegen.farthest_point, with its defaults).
__device__ __forceinline__ int farthest(const int8_t* bd, int p) {
  if (p == 0) {
    for (int i = 18; i < 24; ++i)
      if (bd[i] > 0) return i;
    return 18;
  }
  for (int i = 5; i >= 0; --i)
    if (bd[24 + i] > 0) return i;
  return 5;
}

// movegen.slot_params: the submove of 27-table slot s with die d on bd.
__device__ __forceinline__ Submove slot_params(const int8_t* bd, int p, int d, int s) {
  Submove m;
  if (s < 24) {
    const int e = s + (p == 0 ? d : -d);
    m.start = s;
    m.end = e < 0 ? 0 : (e > kPoints - 1 ? kPoints - 1 : e);
  } else if (s == 24) {
    m.start = kBar;
    m.end = p == 0 ? d - 1 : kPoints - d;  // bar entry point
  } else {
    m.start = s == 25 ? farthest(bd, p) : (p == 0 ? kPoints - d : d - 1);
    m.end = kOff;
  }
  m.hit = m.end != kOff && bd[(1 - p) * 24 + m.end] == 1;
  return m;
}

// board.apply_submove on one board, in place.
__device__ __forceinline__ void apply(int8_t* bd, int p, const Submove& m) {
  const int q = 1 - p;
  bd[m.start == kBar ? 48 + p : m.start + 24 * p] -= 1;
  bd[m.end == kOff ? 50 + p : m.end + 24 * p] += 1;
  if (m.hit) {
    bd[m.end + 24 * q] -= 1;
    bd[48 + q] += 1;
  }
}

// movegen2._submove_sig: six 5-bit lanes, equal iff the afterstates are.
__device__ __forceinline__ int submove_sig(const Submove& a, const Submove& b, bool pair) {
  const bool c1 = pair && a.start == b.end;
  const bool c2 = pair && b.start == a.end;
  const bool both = pair && !c1 && !c2;
  const int m1 = c1 ? b.start : a.start;
  const int m2 = both ? b.start : kSent;
  const int p1 = c2 ? b.end : a.end;
  const int p2 = both ? b.end : kSent;
  const int t1 = a.hit ? a.end : kSent;
  const int t2 = pair && b.hit ? b.end : kSent;
  int sig = min(m1, m2);
  sig = sig * 32 + max(m1, m2);
  sig = sig * 32 + min(p1, p2);
  sig = sig * 32 + max(p1, p2);
  sig = sig * 32 + min(t1, t2);
  sig = sig * 32 + max(t1, t2);
  return sig;
}

// Inclusive prefix sum of one int per thread over the block (blockDim a
// multiple of 32); *total gets the block's sum. Every thread must call it.
__device__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? s_warp[warp - 1] : 0);
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is free again
  return out;
}

__global__ void __launch_bounds__(kMaxK)
nd_tail_kernel(const uint8_t* __restrict__ valid,
               const int8_t* __restrict__ b1a,
               const int8_t* __restrict__ b1b,
               const int8_t* __restrict__ b0,
               const int32_t* __restrict__ player,
               const int32_t* __restrict__ d_hi,
               const int32_t* __restrict__ d_lo,
               int8_t* __restrict__ after,
               uint8_t* __restrict__ keep,
               int32_t* __restrict__ n_pre,
               int32_t* __restrict__ pct,
               uint8_t* __restrict__ kpair,
               int K, int a_max) {
  __shared__ __align__(16) uint8_t s_valid[kCand];
  __shared__ __align__(16) int8_t s_child[2 * kChild];  // pass A, then pass B
  __shared__ __align__(16) int8_t s_root[kCells];
  __shared__ int s_warp[32];
  // dynamic: signatures int[K], afterstates int8[K][52], selected cells int16[K]
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int* s_sig = reinterpret_cast<int*>(s_dyn);
  int8_t* s_after = reinterpret_cast<int8_t*>(s_dyn + 4 * K);
  int16_t* s_sel = reinterpret_cast<int16_t*>(s_dyn + (4 + kCells) * K);

  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  // 1. stage the row (the wrapper guarantees 16-byte aligned bases; rows of
  //    1512, 1404 and 52 bytes keep 8-, 4- and 4-byte alignment)
  {
    const uint2* src = reinterpret_cast<const uint2*>(valid + row * kCand);
    uint2* dst = reinterpret_cast<uint2*>(s_valid);
    for (int i = t; i < kCand / 8; i += nt) dst[i] = src[i];
    const int* ca = reinterpret_cast<const int*>(b1a + row * kChild);
    const int* cb = reinterpret_cast<const int*>(b1b + row * kChild);
    int* dc = reinterpret_cast<int*>(s_child);
    for (int i = t; i < kChild / 4; i += nt) {
      dc[i] = ca[i];
      dc[kChild / 4 + i] = cb[i];
    }
    if (t < kCells / 4)
      reinterpret_cast<int*>(s_root)[t] = reinterpret_cast<const int*>(b0 + row * kCells)[t];
  }
  const int p = player[row];
  const int dhi = d_hi[row];
  const int dlo = d_lo[row];
  __syncthreads();

  // 2. select: the k-th set cell for k < K, by one block prefix sum
  int total;
  {
    const int chunk = (kCand + nt - 1) / nt;
    const int lo = min(t * chunk, kCand);
    const int hi = min(lo + chunk, kCand);
    int cnt = 0;
    for (int i = lo; i < hi; ++i) cnt += s_valid[i] != 0;
    int rank = block_scan(cnt, s_warp, &total) - cnt;
    for (int i = lo; i < hi && rank < K; ++i)
      if (s_valid[i]) s_sel[rank++] = static_cast<int16_t>(i);
  }
  __syncthreads();

  // 3. one thread per candidate: decode, afterstate, signature
  const int k = t;
  bool ok = false;
  bool kp = false;
  if (k < K) {
    ok = k < total;
    const int idx = ok ? s_sel[k] : kCand - 1;  // the plain version's clip
    const int blk = idx / kSlots;
    const int loc = idx - blk * kSlots;
    const int cpass = blk >= kSlots + 1 ? 1 : 0;
    const int bb = blk - cpass * (kSlots + 1);
    const bool pair = bb < kSlots;
    const int ci = pair ? bb : loc;
    const int8_t* first = s_child + cpass * kChild + ci * kCells;
    int8_t* out = s_after + k * kCells;
#pragma unroll
    for (int w = 0; w < kCells / 4; ++w)
      reinterpret_cast<int*>(out)[w] = reinterpret_cast<const int*>(first)[w];
    kp = ok && pair;
    const Submove m1 = slot_params(s_root, p, cpass == 0 ? dhi : dlo, ci);
    Submove m2 = {0, 0, false};
    if (kp) {
      m2 = slot_params(first, p, cpass == 0 ? dlo : dhi, loc);
      apply(out, p, m2);
    }
    s_sig[k] = submove_sig(m1, m2, kp);
  }
  __syncthreads();

  // 4. first-occurrence dedup (every j < k < total is present), max-submove
  //    filter, Q7 rank cap
  bool kept = false;
  if (ok) {
    const int mine = s_sig[k];
    kept = true;
    for (int j = 0; j < k; ++j)
      if (s_sig[j] == mine) {
        kept = false;
        break;
      }
  }
  const bool has_pair = __syncthreads_or(kept && kp) != 0;
  kept = kept && (kp || !has_pair);
  int survivors;
  const int rank = block_scan(kept ? 1 : 0, s_warp, &survivors);

  if (k < K) {
    keep[row * K + k] = kept && rank <= a_max;
    kpair[row * K + k] = kp;
  }
  if (t == 0) {
    n_pre[row] = total;
    pct[row] = survivors;
  }
  // block_scan ended with a barrier: every afterstate is in shared memory
  const int* src = reinterpret_cast<const int*>(s_after);
  int* dst = reinterpret_cast<int*>(after + row * K * kCells);
  for (int i = t; i < K * (kCells / 4); i += nt) dst[i] = src[i];
}

}  // namespace

extern "C" {

// Largest K the kernel takes (one thread per candidate, one block per row).
int nd_tail_max_k() { return kMaxK; }

// Launch on `stream`. Device pointers, all 16-byte aligned: valid uint8
// [n, 1512] (0/1), b1a and b1b int8 [n, 27, 52], b0 int8 [n, 52], player,
// d_hi, d_lo int32 [n]; outputs after int8 [n, K, 52], keep uint8 [n, K],
// n_pre and pct int32 [n], kpair uint8 [n, K]. Returns cudaGetLastError()
// after the launch (0 on success).
int nd_tail_launch(const void* valid, const void* b1a, const void* b1b,
                   const void* b0, const void* player, const void* d_hi,
                   const void* d_lo, void* after, void* keep, void* n_pre,
                   void* pct, void* kpair, long long n, int K, int a_max,
                   void* stream) {
  if (n <= 0) return 0;
  if (K < 1 || K > kMaxK || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int threads = (K + 31) / 32 * 32;
  const size_t smem = (size_t)K * (4 + kCells + 2);
  nd_tail_kernel<<<(unsigned)n, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int8_t*)b1a, (const int8_t*)b1b,
      (const int8_t*)b0, (const int32_t*)player, (const int32_t*)d_hi,
      (const int32_t*)d_lo, (int8_t*)after, (uint8_t*)keep, (int32_t*)n_pre,
      (int32_t*)pct, (uint8_t*)kpair, K, a_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
