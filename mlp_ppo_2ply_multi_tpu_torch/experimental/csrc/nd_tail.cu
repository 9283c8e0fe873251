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
// What bounds it. Per row the function reads 1512 candidate bytes, the
// 52-byte child rows its selected candidates use (of the two 27-row tables;
// many candidates share a first-slot child, so about 8 rows in the 2-ply
// step's data), the 52-byte root and three ints, and writes K x 52 + 2K + 8
// bytes (5,192 B at K = 96). Its arithmetic is a few hundred integer
// operations per candidate plus K(K-1)/2 signature compares per row, ~0.3 us
// of the CUDA cores at [4096, 96] against ~8.8 us for the bytes at
// 3.35 TB/s: bytes bound it.
//
// What the design does about it. One warp per row, no block barrier: lane l
// takes candidates l, l + 32, ... (3 groups at K = 96, 18 at K = 576). The
// select reads the row's candidate bytes as 8-byte words (six loads a lane,
// all issued before use), turns each into an 8-bit mask and ranks the set
// cells with a warp-shuffle scan; the first K indices go to shared memory.
// Each candidate reads its 52-byte child straight from the pass-A or pass-B
// table (L1/L2; only the children the selected candidates use are read, not
// both 1,404-byte tables), applies its second submove in its own 52-byte slot of
// a per-warp staging buffer and writes its signature to shared memory; the
// staged group of 32 afterstates then leaves in coalesced 4-byte words (a
// lane's own 52-byte rows would be 13 strided stores touching ~8x the L2
// sectors). Dedup compares a signature with the earlier ones (broadcast
// reads), has_pair is __any_sync and the Q7 rank a __ballot_sync prefix.
// Shared memory is 6 B x K + 1,664 B a row (2.2 KB at K = 96), so a CTA of 4
// warps (rows) needs no opt-in and 4,096 rows run in one wave.
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
constexpr int kMaxK = 576;                  // 18 groups of 32 candidates
constexpr int kWarps = 4;                   // rows a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 32 * kCells;         // one group's afterstates
constexpr int kRounds = (kCand / 8 + 31) / 32;  // 8-byte loads a lane: 6

// Shared bytes of one warp (row): signatures, staging, selected cells.
__host__ __device__ constexpr int warp_bytes(int K) {
  return (4 * K + kStage + 2 * K + 15) / 16 * 16;
}

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

// Set-byte mask of a 4-byte word (bit i for byte i != 0).
__device__ __forceinline__ unsigned nz4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__global__ void __launch_bounds__(kThreads)
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
               long long n, int K, int a_max) {
  // per warp: signatures int[K], staging int8[32][52], selected cells int16[K]
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warps only; no block barrier follows
  unsigned char* mine = s_dyn + (size_t)warp * warp_bytes(K);
  int* s_sig = reinterpret_cast<int*>(mine);
  int8_t* s_stage = reinterpret_cast<int8_t*>(mine + 4 * K);
  int16_t* s_sel = reinterpret_cast<int16_t*>(mine + 4 * K + kStage);
  const unsigned full = 0xffffffffu;
  const unsigned lt = (1u << lane) - 1u;

  // 1. select: rank the set cells with a warp scan, keep the first K
  const uint2* vrow = reinterpret_cast<const uint2*>(valid + row * kCand);
  uint2 v[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int wi = r * 32 + lane;
    v[r] = wi < kCand / 8 ? vrow[wi] : make_uint2(0u, 0u);
  }
  int total = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    unsigned bits = nz4(v[r].x) | (nz4(v[r].y) << 4);
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += y;
    }
    int rank = total + incl - cnt;
    const int base = 8 * (r * 32 + lane);
    while (bits && rank < K) {
      s_sel[rank++] = static_cast<int16_t>(base + __ffs(bits) - 1);
      bits &= bits - 1;
    }
    total += __shfl_sync(full, incl, 31);
  }
  __syncwarp();

  const int p = player[row];
  const int dhi = d_hi[row];
  const int dlo = d_lo[row];
  const int8_t* root = b0 + row * kCells;
  const int groups = (K + 31) / 32;

  // 2. candidates k = 32 i + lane: decode, afterstate, signature; each
  //    group's afterstates leave the staging buffer in coalesced words
  unsigned okm = 0, kpm = 0;
  for (int i = 0; i < groups; ++i) {
    const int k = 32 * i + lane;
    if (k < K) {
      const bool ok = k < total;
      const int idx = ok ? s_sel[k] : kCand - 1;  // the plain version's clip
      const int blk = idx / kSlots;
      const int loc = idx - blk * kSlots;
      const int cpass = blk >= kSlots + 1 ? 1 : 0;
      const int bb = blk - cpass * (kSlots + 1);
      const bool pair = bb < kSlots;
      const int ci = pair ? bb : loc;
      const int* first = reinterpret_cast<const int*>(
          (cpass ? b1b : b1a) + row * kChild + ci * kCells);
      int8_t* out = s_stage + lane * kCells;
#pragma unroll
      for (int w = 0; w < kCells / 4; ++w) reinterpret_cast<int*>(out)[w] = first[w];
      const bool kp = ok && pair;
      const Submove m1 = slot_params(root, p, cpass == 0 ? dhi : dlo, ci);
      Submove m2 = {0, 0, false};
      if (kp) {
        m2 = slot_params(out, p, cpass == 0 ? dlo : dhi, loc);
        apply(out, p, m2);
      }
      s_sig[k] = submove_sig(m1, m2, kp);
      okm |= (unsigned)ok << i;
      kpm |= (unsigned)kp << i;
    }
    __syncwarp();
    const int words = min(32, K - 32 * i) * (kCells / 4);
    const int* src = reinterpret_cast<const int*>(s_stage);
    int* dst = reinterpret_cast<int*>(after + (row * K + 32 * i) * kCells);
    for (int w = lane; w < words; w += 32) dst[w] = src[w];
    __syncwarp();
  }

  // 3. first-occurrence dedup (every j < k < total is present)
  unsigned keptm = 0;
  for (int i = 0; i < groups; ++i) {
    if (!((okm >> i) & 1u)) continue;
    const int k = 32 * i + lane;
    const int sig = s_sig[k];
    bool kept = true;
    for (int j = 0; j < k; ++j)
      if (s_sig[j] == sig) {
        kept = false;
        break;
      }
    keptm |= (unsigned)kept << i;
  }

  // 4. max-submove filter, Q7 rank cap
  const bool has_pair = __any_sync(full, (keptm & kpm) != 0u);
  int survivors = 0;
  for (int i = 0; i < groups; ++i) {
    const int k = 32 * i + lane;
    const bool kp = (kpm >> i) & 1u;
    const bool kept = ((keptm >> i) & 1u) && (kp || !has_pair);
    const unsigned bal = __ballot_sync(full, kept);
    const int rank = survivors + __popc(bal & lt) + 1;  // inclusive
    if (k < K) {
      keep[row * K + k] = kept && rank <= a_max;
      kpair[row * K + k] = kp;
    }
    survivors += __popc(bal);
  }
  if (lane == 0) {
    n_pre[row] = total;
    pct[row] = survivors;
  }
}

}  // namespace

extern "C" {

// Largest K the kernel takes (candidate groups fit a 32-bit mask).
int nd_tail_max_k() { return kMaxK; }

// Dynamic shared memory of one CTA (kWarps rows) at width K, in bytes.
int nd_tail_smem(int K) { return kWarps * warp_bytes(K); }

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
  const long long blocks = (n + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * warp_bytes(K);
  nd_tail_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int8_t*)b1a, (const int8_t*)b1b,
      (const int8_t*)b0, (const int32_t*)player, (const int32_t*)d_hi,
      (const int32_t*)d_lo, (int8_t*)after, (uint8_t*)keep, (int32_t*)n_pre,
      (int32_t*)pct, (uint8_t*)kpair, n, K, a_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
