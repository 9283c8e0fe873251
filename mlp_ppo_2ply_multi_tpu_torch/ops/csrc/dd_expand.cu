// Canonical doubles enumeration for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package runs this enumeration
// (engine/movegen2.py::enumerate_doubles) as plain XLA, and so did the port,
// as some hundreds of small element-wise kernels a call whose [n, W, 27] slot
// grids, index tensors and per-level board copies all went through device
// memory. One launch here computes the whole function for n games, each
// rolling the double of its die:
//
//   0. the root's 27-slot table (movegen.slot_table) and its context
//      (movegen.slot_ctx: the opponent-side tests, fixed for the turn);
//   1. three canonical level expansions (movegen2._expand): a child is a
//      legal slot of its parent whose submove rank is at least the rank of
//      the parent's last submove, so no multiset is reached twice; children
//      are kept in (parent, slot) order and the first w_{L+1} of them fill
//      the next level, the rest flag overflow;
//   2. the forced shorts of levels 1-3 (an entry whose parent had one legal
//      slot in all, and which has none);
//   3. the level gating (level 4 if it holds a move, else the shorts of
//      level 3, 2, 1), the Q7 rank-capped compaction of the chosen level to
//      a_max entries, and the merge into the output, count and overflow.
//
// Outputs: boards int8 [n, a_max, 52], valid and overflow bytes, count int32.
// They equal the plain version's (movegen2.enumerate_doubles_plain) byte for
// byte, invalid entries included: a child beyond its level's count is a copy
// of the last parent, unchanged (the plain select clips to the last
// (parent, slot) cell and applies nothing), a short level's invalid entries
// keep their frontier boards, and padding past the chosen level is zero.
//
// What bounds it. Per game the function reads a 52-byte board and two
// integers and writes a_max x 53 + 5 bytes (23.7 KB at the 1-ply widths,
// 16 + 96 + 224 + 448 entries, a_max 448). Its work is a few hundred
// integer operations per frontier entry: ~0.8 M entries a 1-ply call, well
// under the ~7 us the bytes take at 3.35 TB/s. So bytes bound it, and the
// design keeps every intermediate out of device memory.
//
// What the design does about it. A game's whole frontier (all four levels,
// (1 + w1 + w2 + w3 + w4) x 52 bytes), its per-entry flags, its child masks
// and one scan buffer live in shared memory; the output is the only global
// memory written. A team of threads runs one game: a warp when no level is
// wider than 128 entries (the 2-ply reply widths; a few games a block), else
// a block of 256 threads (the 1-ply and Config() widths; one game a block).
// Each entry carries a 27-bit child mask (legal slots at or above its rank);
// an exclusive scan of their popcounts gives each parent its first child's
// place, so child k finds its parent by a binary search over the scan and
// its slot as the (k - offset)-th set bit: movegen2._select_set_bits over
// the flattened [W, 27] grid, without the grid. The thread that builds a
// child copies its parent's 13 words, applies the submove in place, and
// computes the child's slot table, flags and mask from the bytes it just
// wrote. The scan also sums the short flags, which gives the gating.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 52;
constexpr int kWords = kCells / 4;  // 13
constexpr int kPoints = 24;
constexpr int kBar = 24;   // submove start: the bar
constexpr int kOff = 25;   // submove end: borne off
constexpr int kLevels = 4;
constexpr int kBlockTeam = 256;  // threads of a game that has a block to itself
constexpr int kMaxWarpGames = 8;  // games (warps) a block, for warp teams
constexpr int kMaxWidth = 2048;   // a level's width (the scan packs counts in 16 bits)
constexpr int kTeamBytes = 64;    // a block team's warp totals
constexpr int kMaxSmem = 232448;  // 227 KB, a block's shared memory on sm_90

// Entry flags.
constexpr uint8_t kValid = 1;   // a legal partial move
constexpr uint8_t kShort = 2;   // a forced short (levels 1-3)
constexpr uint8_t kSingle = 4;  // exactly one legal slot: its children arrive forced

struct Widths {
  int w[kLevels + 1];  // w[0] = 1, the root; then w1..w4
  int a_max;
};

// Shared memory of one game, in bytes from the game's base: boards, flags,
// child masks (levels 0-3), the scan buffer, the team's warp totals.
struct Layout {
  int base[kLevels + 2];  // first entry of level L; base[5] entries in all
  int flags, masks, scan, team, bytes;
};

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(const Widths& W) {
  Layout l;
  l.base[0] = 0;
  for (int i = 0; i <= kLevels; ++i) l.base[i + 1] = l.base[i] + W.w[i];
  const int entries = l.base[kLevels + 1];
  const int masked = l.base[kLevels];  // levels 0-3 expand
  int widest = 1;
  for (int i = 1; i < kLevels; ++i) widest = W.w[i] > widest ? W.w[i] : widest;
  l.flags = up16(entries * kCells);
  l.masks = l.flags + up16(entries);
  l.scan = l.masks + up16(4 * masked);
  l.team = l.scan + up16(4 * widest);
  l.bytes = l.team + kTeamBytes;
  return l;
}

// The threads that run one game: a warp, or a whole block.
template <int G>
struct Team;

template <>
struct Team<32> {
  __device__ static int rank() { return threadIdx.x & 31; }
  __device__ static void sync() { __syncwarp(); }
  // inclusive prefix sum of v over the team; `total` the team's sum
  __device__ static int scan(int v, int& total, int*) {
    const int lane = threadIdx.x & 31;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    total = __shfl_sync(0xffffffffu, x, 31);
    return x;
  }
};

template <>
struct Team<kBlockTeam> {
  __device__ static int rank() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ static int scan(int v, int& total, int* s_team) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int x = Team<32>::scan(v, total, nullptr);
    if (lane == 31) s_team[warp] = total;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int i = 0; i < kBlockTeam / 32; ++i) {
      const int t = s_team[i];
      before += i < warp ? t : 0;
      total += t;
    }
    __syncthreads();  // s_team is free again
    return x + before;
  }
};

// The opponent-side slot tests of the turn (movegen.SlotCtx on the root).
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

// movegen.slot_valid with a root context: the 27 slot bits of a board, and
// its farthest occupied home point (movegen.farthest_point).
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

// movegen.farthest_point: the farthest occupied home point, with its defaults.
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

// Slots whose canonical rank (movegen2._rank_lanes) is at least `lr`, the
// rank of the entry's last submove; `last` is the entry's farthest point.
__device__ __forceinline__ uint32_t rank_gate(int lr, int last, int p, int d) {
  const int t = lr <= 0 ? 0 : (lr + 1) >> 1;  // point i passes iff its adj >= t
  uint32_t m = 0;
  if (t < kPoints) m = p == 0 ? (0xFFFFFFu << t) & 0xFFFFFFu : (1u << (kPoints - t)) - 1u;
  if (lr <= -1) m |= 1u << 24;
  const int adj_last = p == 0 ? last : kPoints - 1 - last;
  if (2 * adj_last + 1 >= lr) m |= 1u << 25;
  if (2 * (kPoints - d) + 1 >= lr) m |= 1u << 26;
  return m;
}

// movegen2._submove_rank of slot s played on a board whose farthest point is `last`.
__device__ __forceinline__ int submove_rank(int s, int last, int p, int d) {
  if (s < kPoints) return 2 * (p == 0 ? s : kPoints - 1 - s);
  if (s == kBar) return -1;
  if (s == 25) return 2 * (p == 0 ? last : kPoints - 1 - last) + 1;
  return 2 * (kPoints - d) + 1;
}

// movegen.slot_params: the submove of slot s with die d on bd.
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

// Position of the j-th (from 0) set bit of m; j < popc(m).
__device__ __forceinline__ int nth_bit(uint32_t m, int j) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const uint32_t lo = m & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (j >= c) {
      j -= c;
      m >>= w;
      pos += w;
    } else {
      m = lo;
    }
  }
  return pos;
}

// The largest e < w with off[e] <= k (off nondecreasing in its low 16 bits,
// off[0] = 0 <= k): the parent of child k.
__device__ __forceinline__ int find_parent(const int* off, int w, int k) {
  int lo = 0, hi = w - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((off[mid] & 0xFFFF) <= k) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Exclusive scan over a level's w entries of popc(mask) + (short << 16)
// into off; returns the packed totals (children in the low 16 bits, shorts
// above).
template <int G>
__device__ __forceinline__ int scan_level(const uint32_t* masks, const uint8_t* flags, int* off,
                                          int* s_team, int w, int tid) {
  int carry = 0;
  for (int base = 0; base < w; base += G) {
    const int e = base + tid;
    int v = 0;
    if (e < w) v = __popc(masks[e]) | ((flags[e] & kShort) ? 1 << 16 : 0);
    int total;
    const int incl = Team<G>::scan(v, total, s_team);
    if (e < w) off[e] = carry + incl - v;
    carry += total;
  }
  Team<G>::sync();
  return carry;
}

template <int G>
__global__ void __launch_bounds__(kBlockTeam)
dd_expand_kernel(const int8_t* __restrict__ board, long long board_stride,
                 const long long* __restrict__ player, long long player_stride,
                 const long long* __restrict__ die, long long die_stride,
                 int8_t* __restrict__ out, uint8_t* __restrict__ out_valid,
                 int32_t* __restrict__ out_count, uint8_t* __restrict__ out_overflow,
                 long long n, Widths W, int games, int game_bytes) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int tid = Team<G>::rank();
  const int slot = G == 32 ? (int)(threadIdx.x >> 5) : 0;
  const long long game = (long long)blockIdx.x * games + slot;
  if (game >= n) return;  // whole teams only: a warp team syncs itself alone
  unsigned char* mine = s_dyn + (size_t)slot * game_bytes;
  const Layout L = layout(W);
  int8_t* s_boards = reinterpret_cast<int8_t*>(mine);
  uint8_t* s_flags = mine + L.flags;
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(mine + L.masks);
  int* s_scan = reinterpret_cast<int*>(mine + L.scan);
  int* s_team = reinterpret_cast<int*>(mine + L.team);

  const int p = player[game * player_stride] != 0;
  // a die outside 1..6, which the plain chain refuses, reads as the nearest
  // face: every board index below stays inside the game's board
  const int d = (int)min(max(die[game * die_stride], 1LL), 6LL);
  const int8_t* root = board + game * board_stride;
  for (int c = tid; c < kCells; c += G) s_boards[c] = root[c];
  Team<G>::sync();
  const Ctx ctx = root_ctx(s_boards, p, d);

  // level 0: the root, every slot open (ranks are >= -1)
  if (tid == 0) {
    const Slots st = slot_valid(s_boards, p, d, ctx);
    s_masks[0] = st.valid;
    s_flags[0] = kValid | (__popc(st.valid) == 1 ? kSingle : 0);
  }
  Team<G>::sync();
  int packed = scan_level<G>(s_masks, s_flags, s_scan, s_team, 1, tid);

  int children[kLevels];  // legal children of each level 0-3, before the width cut
  int shorts[kLevels];    // shorts of each level (level 0's unused)
  for (int lv = 0; lv < kLevels; ++lv) {
    children[lv] = packed & 0xFFFF;
    shorts[lv] = packed >> 16;
    const int wp = W.w[lv], wc = W.w[lv + 1];
    const int8_t* pb = s_boards + L.base[lv] * kCells;
    const uint32_t* pm = s_masks + L.base[lv];
    const uint8_t* pf = s_flags + L.base[lv];
    int8_t* cb = s_boards + L.base[lv + 1] * kCells;
    uint8_t* cf = s_flags + L.base[lv + 1];
    uint32_t* cm = s_masks + L.base[lv + 1];
    const bool stats = lv + 1 < kLevels;
    for (int k = tid; k < wc; k += G) {
      const bool ok = k < children[lv];
      int e = wp - 1, s = 26;  // past the children: the plain select's clip, applied as a no-op
      if (ok) {
        e = find_parent(s_scan, wp, k);
        s = nth_bit(pm[e], k - (s_scan[e] & 0xFFFF));
      }
      const int8_t* parent = pb + e * kCells;
      int8_t* child = cb + k * kCells;
      const uint32_t* from = reinterpret_cast<const uint32_t*>(parent);
      uint32_t* to = reinterpret_cast<uint32_t*>(child);
#pragma unroll
      for (int i = 0; i < kWords; ++i) to[i] = from[i];
      int rank = 0;
      if (ok) {
        const int last = s == 25 ? farthest(parent, p) : 0;  // read by slot 25 alone
        apply(child, p, slot_params(parent, p, d, s, last));
        rank = submove_rank(s, last, p, d);
      }
      if (stats) {
        const Slots st = slot_valid(child, p, d, ctx);
        const int full = __popc(st.valid);
        const bool only = (pf[e] & kSingle) != 0;
        cm[k] = ok ? st.valid & rank_gate(rank, st.last, p, d) : 0u;
        cf[k] = (ok ? kValid : 0) | (ok && only && full == 0 ? kShort : 0) |
                (full == 1 ? kSingle : 0);
      } else {
        cf[k] = ok ? kValid : 0;
      }
    }
    Team<G>::sync();
    if (stats) packed = scan_level<G>(cm, cf, s_scan, s_team, wc, tid);
  }

  // gating: level 4 if it holds a move, else the shorts of level 3, 2, 1
  const int chosen = children[3] > 0 ? 4 : shorts[3] > 0 ? 3 : shorts[2] > 0 ? 2 : 1;
  const int wl = W.w[chosen];
  const int A = W.a_max;
  const uint8_t bit = chosen == 4 ? kValid : kShort;
  const int cnt = chosen == 4 ? min(children[3], W.w[4]) : shorts[chosen];
  const bool overflow = children[0] > W.w[1] || children[1] > W.w[2] || children[2] > W.w[3] ||
                        children[3] > W.w[4] || cnt > A;
  const bool compact = wl > A;  // Q7: the first A set entries, in order
  const uint8_t* lf = s_flags + L.base[chosen];
  if (compact && chosen < 4) {  // level 4's valid entries are a prefix already
    int carry = 0;
    for (int base = 0; base < wl; base += G) {
      const int e = base + tid;
      const int v = e < wl && (lf[e] & bit) ? 1 : 0;
      int total;
      const int r = carry + Team<G>::scan(v, total, s_team) - v;
      if (v && r < A) s_scan[r] = e;
      carry += total;
    }
    Team<G>::sync();
  }

  const uint32_t* lw = reinterpret_cast<const uint32_t*>(s_boards + L.base[chosen] * kCells);
  uint32_t* ow = reinterpret_cast<uint32_t*>(out + game * A * kCells);
  for (int i = tid; i < A * kWords; i += G) {
    const int k = i / kWords;
    int src;
    if (!compact) src = k < wl ? k : -1;  // zero padding past the level
    else src = k < cnt ? (chosen == 4 ? k : s_scan[k]) : wl - 1;
    ow[i] = src >= 0 ? lw[src * kWords + (i - k * kWords)] : 0u;
  }
  uint8_t* ov = out_valid + game * A;
  for (int k = tid; k < A; k += G) ov[k] = compact ? k < cnt : k < wl && (lf[k] & bit);
  if (tid == 0) {
    out_count[game] = cnt < A ? cnt : A;
    out_overflow[game] = overflow;
  }
}

bool widths_ok(const Widths& W) {
  for (int i = 1; i <= kLevels; ++i)
    if (W.w[i] < 1 || W.w[i] > kMaxWidth) return false;
  return W.a_max >= 1 && W.a_max <= kMaxWidth;
}

Widths widths(int w1, int w2, int w3, int w4, int a_max) {
  Widths W;
  W.w[0] = 1;
  W.w[1] = w1;
  W.w[2] = w2;
  W.w[3] = w3;
  W.w[4] = w4;
  W.a_max = a_max;
  return W;
}

template <int G>
int launch(const void* board, long long board_stride, const void* player,
           long long player_stride, const void* die, long long die_stride, void* out,
           void* valid, void* count, void* overflow, long long n, const Widths& W, int games,
           cudaStream_t stream) {
  const int game_bytes = layout(W).bytes;
  const int smem = games * game_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dd_expand_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + games - 1) / games;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dd_expand_kernel<G><<<(unsigned)blocks, G * games, smem, stream>>>(
      (const int8_t*)board, board_stride, (const long long*)player, player_stride,
      (const long long*)die, die_stride, (int8_t*)out, (uint8_t*)valid, (int32_t*)count,
      (uint8_t*)overflow, n, W, games, game_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one game at these widths, in bytes (a multiple of 16);
// -1 for widths the kernel does not take.
int dd_expand_game_bytes(int w1, int w2, int w3, int w4, int a_max) {
  const Widths W = widths(w1, w2, w3, w4, a_max);
  return widths_ok(W) ? layout(W).bytes : -1;
}

// Launch on `stream` with `team` threads a game (32: a warp, `games` games a
// block; 256: a block, games 1). Device pointers: board int8 rows of 52 at
// `board_stride` bytes, player (0 or 1) and die (1..6) int64 at their strides
// (0: one value for every game); outputs out int8 [n, a_max, 52], valid uint8
// [n, a_max], count int32 [n], overflow uint8 [n], contiguous and 4-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success).
int dd_expand_launch(const void* board, long long board_stride, const void* player,
                     long long player_stride, const void* die, long long die_stride, void* out,
                     void* valid, void* count, void* overflow, long long n, int w1, int w2,
                     int w3, int w4, int a_max, int team, int games, void* stream) {
  if (n <= 0) return 0;
  const Widths W = widths(w1, w2, w3, w4, a_max);
  if (!widths_ok(W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (team == 32 && games >= 1 && games <= kMaxWarpGames)
    return launch<32>(board, board_stride, player, player_stride, die, die_stride, out, valid,
                      count, overflow, n, W, games, s);
  if (team == kBlockTeam && games == 1)
    return launch<kBlockTeam>(board, board_stride, player, player_stride, die, die_stride, out,
                              valid, count, overflow, n, W, games, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
