// Fused board -> value kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mlp_ppo_2ply_multi_tpu/ops/fused_value.py::_kernel
// (pallas_call in _fused_value_rows). It computes, per int8 board row
// cells[52] with side-to-move flag f:
//
//   r[4c+k] = max(cells[c] - k, 0)              (k = 0..3; the telescoped
//                                                 Tesauro layer 1)
//   z       = r @ G                              (G bf16 [208, 128])
//   hid     = bf16(sigmoid(z + b1' + f * tflip)) (f32 adds, bf16 rounding)
//   out     = hid . w2 + b2                      (w2 bf16 [128], f32 sum)
//
// with the rounding points of the TPU kernel: G, hid and w2 in bf16, every
// product and sum in f32. r holds integers, exact in bf16 for any int8 input,
// and r * G is exact in f32. Unlike the TPU kernel it takes the per-row flag
// and writes the selected value with b2 added: on this card there is no
// concatenate to avoid.
//
// What bounds it. Per row the function reads 52 + 1 bytes and writes 4: at
// 3.35 TB/s that is 0.149 ms for the 8.72 M rows of one 2-ply step, the bound
// (the nonzero lanes of r, ~25 of 208, need less bf16 work than that). This
// design computes the 208-deep product dense on the tensor cores, so two
// floors of its own lie above the bound: the dense product, 2 x 208 x 128
// flop a row (0.47 ms a 2-ply step at 989 TFLOP/s), and the sigmoid, two
// MUFU operations (ex2, rcp) per hidden unit at 16 a clock per SM (~0.55 ms).
//
// What the design does about them.
// * Product: wgmma m64n128k16 (sm_90a), bf16 in, f32 accumulate, with A from
//   registers. A is r, built by each warp for its own 16 rows from the int8
//   cells (a byte permute puts a cell in each half of a word as the bf16
//   bits of 128 + max(n, 0), one fma.relu.bf16x2 per k pair subtracts
//   128 + k; the words are the A fragment of mma.sync m16n8k16, which is
//   wgmma's too), so [N, 208] never exists in memory. B is G, staged once a
//   CTA in shared memory as 13 k steps of 4,096 B, each in the K-major,
//   unswizzled layout its descriptor reads (8 x 16-byte core matrices of 128
//   contiguous bytes, 128 B apart along K and 256 B along N: conflict-free),
//   packed on the host by ops/fused_value.py::pack_g once per parameter set.
//   K = 208 is 13 steps of 16; the bar/off cells sit in the last step and
//   their k > 0 rows of G are zero.
// * Tiles: a warpgroup (4 warps) takes 64 rows x 128 hidden units; a warp
//   owns 16 whole rows of the accumulator, so the head needs no reduction
//   across warps. Three warpgroups a CTA, one persistent CTA an SM (75 KB
//   of shared memory); each warp copies the next tile's
//   cells (832 B) and flags with 16-byte cp.async into a second buffer
//   while it computes this one, and needs no block barrier in the loop.
//   Shared-memory bandwidth, not the tensor cores, bound the mma.sync
//   version tried first (each warp re-read G every 32 rows); wgmma reads G
//   once a 64-row tile, and each warp builds A for its own rows only.
// * Epilogue on the accumulator fragments: + bias chosen by the row's flag,
//   then the sigmoid as the plain version computes it, 1 / (1 + expf(-x)),
//   so hid rounds to the same bf16: an ex2.approx/rcp.approx sigmoid is off
//   by a few f32 ulps and flips the bf16 rounding of some units, and at |w2|
//   up to 1.2 one flip moves a value by up to 4.7e-3, too near the 5e-3
//   gate. It is branch-free, two MUFU operations a unit.
//   Then bf16 rounding, the f32 dot with w2, and a reduction over the quad
//   by shuffles. With three warpgroups an SM, one warpgroup's epilogue
//   (FMA, MUFU) runs while another's product is on the tensor cores; the
//   epilogue's ~18 instructions a unit are the largest cost left.
// * Ragged tail: cp.async zero-fills the rows past n; their outputs are not
//   stored. The wrapper never pads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 52;
constexpr int kHidden = 128;
constexpr int kKSteps = 13;                        // 208 / 16
constexpr int kWarpgroups = 3;                     // a CTA
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;                          // rows a warpgroup takes
constexpr int kWarpRows = 16;                      // of them, a warp's
constexpr int kRowBytes = kWarpRows * kCells;      // 832
constexpr int kWarpBytes = 2 * (kRowBytes + kWarpRows);  // double-buffered
constexpr int kSmemG = kKSteps * 16 * kHidden * 2;  // 53,248
constexpr int kHead = 3 * kHidden;                 // bias0, bias1, w2 (f32)
constexpr int kSmemBytes = kSmemG + kHead * 4 + 4 * kWarpgroups * kWarpBytes;
constexpr int kLBO = 128;                          // core matrices along K
constexpr int kSBO = 256;                          // core matrices along N

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int nbytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int clamp16(long long left) {
  return left >= 16 ? 16 : (left > 0 ? (int)left : 0);
}

// Copy a warp's 16 rows of cells and flags (from row row0) into its
// buffer, 16-byte cp.async; bytes past row n are zero-filled.
__device__ __forceinline__ void issue_rows(int8_t* dcells, int8_t* dflag,
                                           const int8_t* cells, const int8_t* flag,
                                           long long n, long long row0, int lane) {
  const long long left = (n - row0) * kCells;
  const int8_t* src = cells + row0 * kCells;
  for (int i = lane; i < kRowBytes / 16; i += 32) {
    const int nb = clamp16(left - 16LL * i);
    cp_async16(dcells + 16 * i, nb ? src + 16 * i : cells, nb);
  }
  if (lane == 0) {
    const int nb = clamp16(n - row0);
    cp_async16(dflag, nb ? flag + row0 : flag, nb);
  }
}

__device__ __forceinline__ unsigned fma_relu_bf16x2(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The two A registers of one row from its cell word (cells 4s..4s+3): lo
// holds r at (cell 4s+h, k0), (cell 4s+h, k0+1) and hi the same of cell
// 4s+h+2, as bf16 pairs (low half first).
__device__ __forceinline__ void build_a(unsigned w, unsigned sel, unsigned c0, unsigned c1,
                                        unsigned& lo, unsigned& hi) {
  const unsigned m = w & ~(((w >> 7) & 0x01010101u) * 0xFFu);  // max(n, 0) a byte
  const unsigned t = __byte_perm(m, 0u, sel) | 0x43004300u;    // bf16(128 + m)
  const unsigned one = 0x3F803F80u;                            // bf16x2(1, 1)
  const unsigned v0 = fma_relu_bf16x2(t, one, c0);             // max(m - k0, 0)
  const unsigned v1 = fma_relu_bf16x2(t, one, c1);             // max(m - k0 - 1, 0)
  lo = __byte_perm(v0, v1, 0x5410);
  hi = __byte_perm(v0, v1, 0x7632);
}

// d (+)= a @ B for the warpgroup's 64 rows: A from registers (this warp's
// 16 rows, the mma.sync m16n8k16 A fragment), B [16, 128] from shared memory
// by descriptor, f32 accumulators in the m64n128 D fragment.
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], const unsigned (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Keep the compiler from moving reads of the accumulators above the wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of one k step of G: K-major, no swizzle;
// 8 x 16-byte core matrices of 128 contiguous bytes, kLBO bytes apart along
// K and kSBO bytes apart along N.
__device__ __forceinline__ uint64_t g_desc(const void* smem_kstep) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_kstep));
  return ((addr & 0x3FFFFu) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

// bf16(sigmoid(x)) as a float, branch-free, with the plain version's
// rounding: h = 1 / (1 + expf(-x)) as PyTorch's CUDA sigmoid computes it.
// expf is libdevice's (no branch, one MUFU.EX2); the IEEE division becomes
// rcp.approx and one Newton step with an exact (fma) residual, which gives
// the correctly rounded 1 / d but for about one d in 10^6 (then 1 ulp off).
// -x is clamped at 88 so that d stays finite: where the plain version's
// expf overflows (x < -88.72) it gives 0 and this ~6e-39.
__device__ __forceinline__ float hidden(float x) {
  const float d = 1.0f + expf(fminf(-x, 88.0f));
  float r;
  asm("rcp.approx.f32 %0, %1;\n" : "=f"(r) : "f"(d));
  r = fmaf(r, fmaf(-d, r, 1.0f), r);
  return __bfloat162float(__float2bfloat16_rn(r));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_value_kernel(const int8_t* __restrict__ cells,
                   const int8_t* __restrict__ flag,
                   const uint4* __restrict__ gpack,
                   const float* __restrict__ head,
                   float* __restrict__ out,
                   long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sHead = reinterpret_cast<float*>(smem + kSmemG);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;  // warpgroup
  const int wr = warp & 3;   // the warp's 16 rows of the warpgroup's 64
  unsigned char* mine = smem + kSmemG + kHead * 4 + warp * kWarpBytes;
  int8_t* sCells = reinterpret_cast<int8_t*>(mine);                 // 2 buffers
  int8_t* sFlag = reinterpret_cast<int8_t*>(mine + 2 * kRowBytes);  // 2 buffers

  // G (packed as the descriptor reads it) and the head vectors, once per CTA
  for (int i = threadIdx.x; i < kSmemG / 16; i += kThreads)
    cp_async16(smem + 16 * i, gpack + i, 16);
  for (int i = threadIdx.x; i < kHead / 4; i += kThreads)
    cp_async16(sHead + 4 * i, head + 4 * i, 16);
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * kWarpgroups;
  long long tile = (long long)blockIdx.x * kWarpgroups + wg;
  if (tile < ntiles)
    issue_rows(sCells, sFlag, cells, flag, n, tile * kTile + wr * kWarpRows, lane);
  cp_async_commit();
  cp_async_wait<0>();
  // G was written through the generic proxy; wgmma reads it through the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const float b2 = head[kHead];
  const int g = lane >> 2;
  const int q = lane & 3;
  const unsigned sel = 0x4240u + 0x0101u * (unsigned)(q >> 1);
  const unsigned k0 = 2u * (unsigned)(q & 1);
  const unsigned c0 = (0xC300u + k0) * 0x10001u;  // bf16x2(-(128 + k0))
  const unsigned c1 = (0xC301u + k0) * 0x10001u;  // bf16x2(-(129 + k0))
  const float* w2 = sHead + 2 * kHidden;

  for (int it = 0; tile < ntiles; ++it, tile += stride) {
    const int buf = it & 1;
    if (tile + stride < ntiles)
      issue_rows(sCells + (buf ^ 1) * kRowBytes, sFlag + (buf ^ 1) * kWarpRows, cells,
                 flag, n, (tile + stride) * kTile + wr * kWarpRows, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    const int8_t* rows = sCells + buf * kRowBytes;
    const int8_t* flags = sFlag + buf * kWarpRows;

    // A of all 13 k steps, then the 13 products back to back
    unsigned a[kKSteps][4];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const unsigned w0 = *reinterpret_cast<const unsigned*>(rows + g * kCells + 4 * s);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(rows + (g + 8) * kCells + 4 * s);
      build_a(w0, sel, c0, c1, a[s][0], a[s][2]);
      build_a(w1, sel, c0, c1, a[s][1], a[s][3]);
    }
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kKSteps; ++s)
      wgmma_64x128x16(d, a[s], g_desc(smem + s * 16 * kHidden * 2), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);

    // epilogue: rows g and g + 8 of this warp, all 128 hidden units
    const float* bias0 = sHead + (flags[g] ? kHidden : 0);
    const float* bias1 = sHead + (flags[g + 8] ? kHidden : 0);
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < kHidden / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 w = *reinterpret_cast<const float2*>(w2 + col);
      const float2 x0 = *reinterpret_cast<const float2*>(bias0 + col);
      const float2 x1 = *reinterpret_cast<const float2*>(bias1 + col);
      p0 = fmaf(hidden(d[4 * j] + x0.x), w.x, p0);
      p0 = fmaf(hidden(d[4 * j + 1] + x0.y), w.y, p0);
      p1 = fmaf(hidden(d[4 * j + 2] + x1.x), w.x, p1);
      p1 = fmaf(hidden(d[4 * j + 3] + x1.y), w.y, p1);
    }
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    const long long row = tile * kTile + wr * kWarpRows + g;
    if (q == 0 && row < n) out[row] = p0 + b2;
    if (q == 0 && row + 8 < n) out[row + 8] = p1 + b2;
    __syncwarp();  // every lane is done with this buffer before it is refilled
  }
}

}  // namespace

extern "C" {

// Hidden width the kernel is compiled for; the wrapper checks the params.
int fused_value_hidden() { return kHidden; }

// Dynamic shared memory of one CTA, in bytes.
int fused_value_smem() { return kSmemBytes; }

// Launch on `stream`. Device pointers, all 16-byte aligned: cells int8
// [n, 52], flag int8 [n], gpack bf16 [208 * 128] (G as the kernel reads it,
// ops/fused_value.py::pack_g), head f32 [3 * 128 + 1] (b1', b1' + tflip, w2,
// b2), out f32 [n]. Returns cudaGetLastError() after the launch (0 on
// success).
int fused_value_launch(const void* cells, const void* flag, const void* gpack,
                       const void* head, void* out, long long n, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_value_kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long ctas = (ntiles + kWarpgroups - 1) / kWarpgroups;
  const long long slots = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(ctas < slots ? ctas : slots);
  fused_value_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)cells, (const int8_t*)flag, (const uint4*)gpack,
      (const float*)head, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
