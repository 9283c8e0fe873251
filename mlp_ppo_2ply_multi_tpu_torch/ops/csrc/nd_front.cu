// The front of the non-doubles enumeration for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package runs this front
// (engine/movegen2.py::_nd_candidates with no passes handed in) as plain XLA,
// and so did the port, as some 480 small element-wise kernels a call whose
// [n, 27, 52] children, [n, 27, 27] slot grids and their masks all went
// through device memory. One launch here computes the whole front for n games,
// each with its player and its two dice:
//
//   0. d_hi and d_lo, the larger and the smaller die;
//   1. for each ordering pass (pass A: d_hi first, then d_lo; pass B: d_lo
//      first, then d_hi): the root's 27-slot table for the first die
//      (movegen.slot_table) and the 27 first-ply children (board.apply_submove;
//      an invalid slot's child is the root unchanged);
//   2. each child's second-ply slot bits for the other die against the root's
//      SlotCtx of that die (movegen.slot_valid), pair_valid = the first slot
//      valid and the second slot valid, any_pair, single_valid
//      (movegen2._run_pass);
//   3. the reverse-order skip of pass B (a pass A with no pair and exactly one
//      single zeroes pass B) and the 1512 candidate bytes in reference
//      insertion order: pass-A pairs (27 x 27), pass-A singles (27), pass-B
//      pairs, pass-B singles (movegen2._nd_candidates).
//
// Outputs: b1a and b1b int8 [n, 27, 52] (the children of each pass), valid
// uint8 [n, 1512] (0 or 1), d_hi and d_lo int64 [n]. They equal the plain
// version's (movegen2.nd_front_plain) byte for byte, invalid children and
// cells included.
//
// What bounds it. Per game the function reads a 52-byte board, its player
// and its two dice, and writes 2 x 27 x 52 + 1512 + 16 bytes (4.4 KB; 18.1 MB
// at 4096 games, about 6 us at 3.35 TB/s). Its work is a few hundred integer
// operations a child: far under the bytes. So bytes bound it, and the design
// keeps every intermediate out of device memory and stores wide.
//
// What the design does about it. A warp runs one game, a few games a block
// (ops/nd_front.py::plan). The root board sits in shared memory; lane s < 27
// builds child s of a pass in shared memory, in the block's table of that
// pass, and computes from the bytes it just wrote the child's own-side
// checker mask, state kind and farthest point (movegen.SlotStats) and its 27
// second-ply bits against the root's context of the other die. The pair
// masks (one 27-bit row a child) go through a warp vote and shared memory to
// the candidate bytes, built four to a word. Shared memory holds each output
// region of the block contiguous (pass A's children, pass B's, the candidate
// bytes), so the whole block stores each region with 16-byte stores. The
// device functions take the die of each ply as an argument, so that a launch
// over the six first dies of the 2-ply replies can reuse them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 52;
constexpr int kWords = kCells / 4;  // 13
constexpr int kPoints = 24;
constexpr int kBar = 24;  // submove start: the bar
constexpr int kOff = 25;  // submove end: borne off
constexpr int kSlots = 27;
constexpr int kChildren = kSlots * kCells;    // 1404 bytes: one pass's children
constexpr int kCand = 2 * (kSlots + 1) * kSlots;  // 1512 candidate bytes
constexpr int kMasks = 2 * (kSlots + 1);      // pair rows and the singles, both passes
constexpr int kRootBytes = 64;                // a root board, padded
constexpr int kMaxGames = 8;                  // games (warps) a block
constexpr int kMaxSmem = 48 * 1024;           // a block's shared memory without the opt-in

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

// Shared memory of a block of `games` games, in bytes from its base, each
// region holding every game's part in game order: pass A's children, pass B's
// children, the candidate bytes, the root boards, the candidate masks.
struct Layout {
  int a, b, cand, root, masks, bytes;
};

__host__ __device__ inline Layout layout(int games) {
  Layout l;
  l.a = 0;
  l.b = l.a + up16(games * kChildren);
  l.cand = l.b + up16(games * kChildren);
  l.root = l.cand + up16(games * kCand);
  l.masks = l.root + games * kRootBytes;
  l.bytes = l.masks + games * kMasks * 4;
  return l;
}

// The opponent-side slot tests of the turn for one die (movegen.SlotCtx on
// the root).
struct Ctx {
  uint32_t move_ok;  // bit i: the move from point i lands in the board, unblocked
  bool entry_free;   // the bar-entry point is not blocked
};

struct Submove {
  int start, end;
  bool hit;
};

// Byte mask of a word (bit i for byte i > 0, signed).
__device__ __forceinline__ uint32_t gt0_mask4(uint32_t x) {
  return ((__vcmpgts4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ Ctx root_ctx(const int8_t* bd, int p, int d) {
  const int8_t* opp = bd + kPoints * (1 - p);
  const int step = p == 0 ? d : -d;
  Ctx c;
  c.move_ok = 0;
  for (int i = 0; i < kPoints; ++i) {
    const int dest = i + step;
    if (dest >= 0 && dest < kPoints && opp[dest] < 2) c.move_ok |= 1u << i;
  }
  const int entry = p == 0 ? d - 1 : kPoints - d;
  c.entry_free = opp[entry] < 2;
  return c;
}

// movegen.slot_valid with a root context: the 27 slot bits of a board (4-byte
// aligned), and its farthest occupied home point (movegen.farthest_point).
// With the board's own context it is movegen.slot_table's valid.
struct Slots {
  uint32_t valid;
  int last;
};

__device__ __forceinline__ Slots slot_valid(const int8_t* bd, int p, int d, const Ctx& c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(bd) + 6 * p;
  uint32_t own = 0;  // bit i: the mover holds a checker on point i
#pragma unroll
  for (int i = 0; i < 6; ++i) own |= gt0_mask4(w[i]) << (4 * i);
  const int bar = bd[48 + p];
  const int off = bd[50 + p];
  const uint32_t outside = own & (p == 0 ? 0x03FFFFu : 0xFFFFC0u);
  const int kind = off == 15 ? 3 : bar > 0 ? 1 : outside == 0 ? 2 : 0;
  Slots s;
  if (p == 0) {
    const uint32_t h = (own >> 18) & 63u;
    s.last = h ? 17 + __ffs(h) : 18;
  } else {
    const uint32_t h = own & 63u;
    s.last = h ? 31 - __clz(h) : 5;
  }
  uint32_t v = kind == 0 || kind == 2 ? own & c.move_ok : 0u;
  if (kind == 1 && c.entry_free) v |= 1u << 24;
  if (kind == 2) {
    if (p == 0 ? s.last + d >= kPoints : s.last - d < 0) v |= 1u << 25;
    const int exact = p == 0 ? kPoints - d : d - 1;
    if (exact != s.last && ((own >> exact) & 1u)) v |= 1u << 26;
  }
  s.valid = v;
  return s;
}

// movegen.slot_params: the submove of slot s with die d on bd, whose farthest
// point is `last`.
__device__ __forceinline__ Submove slot_params(const int8_t* bd, int p, int d, int s, int last) {
  Submove m;
  if (s < kPoints) {
    const int e = s + (p == 0 ? d : -d);
    m.start = s;
    m.end = e < 0 ? 0 : (e > kPoints - 1 ? kPoints - 1 : e);
  } else if (s == kBar) {
    m.start = kBar;
    m.end = p == 0 ? d - 1 : kPoints - d;  // bar entry point
  } else {
    m.start = s == 25 ? last : (p == 0 ? kPoints - d : d - 1);
    m.end = kOff;
  }
  m.hit = m.end != kOff && bd[(1 - p) * kPoints + m.end] == 1;
  return m;
}

// board.apply_submove on one board, in place.
__device__ __forceinline__ void apply(int8_t* bd, int p, const Submove& m) {
  const int q = 1 - p;
  bd[m.start == kBar ? 48 + p : m.start + kPoints * p] -= 1;
  bd[m.end == kOff ? 50 + p : m.end + kPoints * p] += 1;
  if (m.hit) {
    bd[m.end + kPoints * q] -= 1;
    bd[48 + q] += 1;
  }
}

// One ordering pass of one game, run by its warp (movegen2._run_pass): the
// first-ply slots `first` (the root's slot bits for die d1) and the root's
// farthest point `last`; lane s < 27 writes child s into `children` (27 rows
// of 52 bytes, 4-byte aligned) and returns its pair row: the second-ply slot
// bits for die d2 against the root context c2 where slot s is valid, else 0.
__device__ __forceinline__ uint32_t front_pass(const int8_t* root, int8_t* children, int p,
                                               int d1, int d2, uint32_t first, int last,
                                               const Ctx& c2, int lane) {
  if (lane >= kSlots) return 0u;
  int8_t* child = children + lane * kCells;
  const uint32_t* from = reinterpret_cast<const uint32_t*>(root);
  uint32_t* to = reinterpret_cast<uint32_t*>(child);
#pragma unroll
  for (int i = 0; i < kWords; ++i) to[i] = from[i];
  if (!((first >> lane) & 1u)) return 0u;  // the child is the root, unchanged
  apply(child, p, slot_params(root, p, d1, lane, last));
  return slot_valid(child, p, d2, c2).valid;
}

// Copy `bytes` (a multiple of 4) from shared memory (16-byte aligned) to
// device memory (4-byte aligned) by the block's threads: 16-byte stores where
// the destination is 16-byte aligned, else 4-byte stores.
__device__ __forceinline__ void store_region(uint8_t* dst, const unsigned char* src, int bytes) {
  const int words = bytes >> 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = words >> 2;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = tid; i < vecs; i += nt) d4[i] = s4[i];
    done = 4 * vecs;
  }
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int i = done + tid; i < words; i += nt) d[i] = s[i];
}

__global__ void __launch_bounds__(32 * kMaxGames)
nd_front_kernel(const int8_t* __restrict__ board, long long board_stride,
                const long long* __restrict__ player, long long player_stride,
                const long long* __restrict__ dice, long long dice_stride0,
                long long dice_stride1, int8_t* __restrict__ b1a, int8_t* __restrict__ b1b,
                uint8_t* __restrict__ valid, long long* __restrict__ d_hi_out,
                long long* __restrict__ d_lo_out, long long n, int games) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const Layout L = layout(games);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g0 = (long long)blockIdx.x * games;
  const int live = (int)min((long long)games, n - g0);  // games of this block

  if (warp < live) {
    const long long game = g0 + warp;
    int8_t* root = reinterpret_cast<int8_t*>(s_dyn + L.root) + warp * kRootBytes;
    const int8_t* src = board + game * board_stride;
    for (int c = lane; c < kCells; c += 32) root[c] = src[c];
    const int p = player[game * player_stride] != 0;
    const long long x = dice[game * dice_stride0];
    const long long y = dice[game * dice_stride0 + dice_stride1];
    const long long hi = x > y ? x : y, lo = x > y ? y : x;
    if (lane == 0) {
      d_hi_out[game] = hi;
      d_lo_out[game] = lo;
    }
    // a die outside 1..6, which the plain chain does not take, reads as the
    // nearest face: every board index below stays inside the game's board
    const int dh = (int)min(max(hi, 1LL), 6LL);
    const int dl = (int)min(max(lo, 1LL), 6LL);
    __syncwarp();

    // the root's context and slot bits for each die (every lane alike)
    const Ctx ch = root_ctx(root, p, dh), cl = root_ctx(root, p, dl);
    const Slots rh = slot_valid(root, p, dh, ch), rl = slot_valid(root, p, dl, cl);
    int8_t* kids_a = reinterpret_cast<int8_t*>(s_dyn + L.a) + warp * kChildren;
    int8_t* kids_b = reinterpret_cast<int8_t*>(s_dyn + L.b) + warp * kChildren;
    const uint32_t pair_a = front_pass(root, kids_a, p, dh, dl, rh.valid, rh.last, cl, lane);
    const uint32_t pair_b = front_pass(root, kids_b, p, dl, dh, rl.valid, rl.last, ch, lane);
    const bool any_a = __any_sync(0xffffffffu, pair_a != 0u);
    const bool any_b = __any_sync(0xffffffffu, pair_b != 0u);
    const uint32_t single_a = any_a ? 0u : rh.valid;
    // the reverse-order skip: a pass A with no pair and one single zeroes pass B
    const bool skip_b = !any_a && __popc(single_a) == 1;
    const uint32_t single_b = any_b || skip_b ? 0u : rl.valid;

    // the candidate masks, one a block of 27 cells: pass-A pair rows, pass-A
    // singles, pass-B pair rows, pass-B singles
    uint32_t* masks = reinterpret_cast<uint32_t*>(s_dyn + L.masks) + warp * kMasks;
    if (lane < kSlots) {
      masks[lane] = pair_a;
      masks[kSlots + 1 + lane] = skip_b ? 0u : pair_b;
    }
    if (lane == 0) {
      masks[kSlots] = single_a;
      masks[2 * kSlots + 1] = single_b;
    }
    __syncwarp();
    uint32_t* cand = reinterpret_cast<uint32_t*>(s_dyn + L.cand + warp * kCand);
    for (int w = lane; w < kCand / 4; w += 32) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * w + k;
        const int blk = c / kSlots;
        word |= ((masks[blk] >> (c - kSlots * blk)) & 1u) << (8 * k);
      }
      cand[w] = word;
    }
  }
  __syncthreads();
  store_region(reinterpret_cast<uint8_t*>(b1a + g0 * kChildren), s_dyn + L.a, live * kChildren);
  store_region(reinterpret_cast<uint8_t*>(b1b + g0 * kChildren), s_dyn + L.b, live * kChildren);
  store_region(valid + g0 * kCand, s_dyn + L.cand, live * kCand);
}

}  // namespace

extern "C" {

// Shared memory of a block of `games` games, in bytes; -1 for a count the
// kernel does not take (1..8).
int nd_front_smem_bytes(int games) {
  if (games < 1 || games > kMaxGames) return -1;
  return layout(games).bytes;
}

// Launch on `stream` with `games` games (warps) a block. Device pointers:
// board int8 rows of 52 at `board_stride` bytes; player (0 or 1) int64 at its
// stride (0: one value for every game); dice int64 at strides (row, die);
// outputs b1a and b1b int8 [n, 27, 52], valid uint8 [n, 1512], d_hi and d_lo
// int64 [n], contiguous and 4-byte aligned (16-byte aligned for the wide
// stores). Returns cudaGetLastError() after the launch (0 on success).
int nd_front_launch(const void* board, long long board_stride, const void* player,
                    long long player_stride, const void* dice, long long dice_stride0,
                    long long dice_stride1, void* b1a, void* b1b, void* valid, void* d_hi,
                    void* d_lo, long long n, int games, void* stream) {
  if (n <= 0) return 0;
  if (games < 1 || games > kMaxGames) return (int)cudaErrorInvalidValue;
  const int smem = layout(games).bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + games - 1) / games;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  nd_front_kernel<<<(unsigned)blocks, 32 * games, smem, (cudaStream_t)stream>>>(
      (const int8_t*)board, board_stride, (const long long*)player, player_stride,
      (const long long*)dice, dice_stride0, dice_stride1, (int8_t*)b1a, (int8_t*)b1b,
      (uint8_t*)valid, (long long*)d_hi, (long long*)d_lo, n, games);
  return (int)cudaGetLastError();
}

}  // extern "C"
