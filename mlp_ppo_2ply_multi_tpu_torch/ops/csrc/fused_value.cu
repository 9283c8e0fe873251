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
// and r * G is exact in f32, so the kernel differs from the plain PyTorch
// version (ops/fused_value.py::fused_value_plain) only by the order of the
// f32 sums. Unlike the TPU kernel it takes the per-row flag and writes the
// selected value with b2 added: on this card there is no concatenate to avoid.
//
// What bounds it. Per row the function reads 52 + 1 bytes and writes 4. The
// layer-1 product counted dense is 2 * 208 * 128 flop per row, which at the
// bf16 tensor-core peak (989 TFLOP/s) outweighs the bytes at 3.35 TB/s about
// threefold; counted as this data needs it (only the nonzero lanes of r,
// typically 20-40 of 208 on a board of 30 checkers) the bytes bound it.
//
// What the design does about it. This first version is a simple SIMT kernel:
// it exploits the sparsity of r instead of the tensor cores. Each CTA stages
// G (53,248 B, so dynamic shared memory above the 48 KB default) once and
// walks over 64-row tiles of boards (persistent grid, a few CTAs per SM).
// One warp evaluates one row at a time: each lane owns 4 of the 128 hidden
// units and adds (n - k) * G[4c+k, lane*4 .. lane*4+3] for every nonzero lane
// of r, reading G as 8-byte bf16x4 words (conflict-free). The warp's loop
// trip count depends only on the row, so the warp never diverges. A head dot
// over the lane's 4 hidden units and a warp shuffle reduction finish the row.
// The features never reach device memory. A tensor-core (mma/wgmma) version
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCells = 52;
constexpr int kPointCells = 48;
constexpr int kRep = 4 * kCells;  // 208
constexpr int kHidden = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kSmemG = kRep * kHidden * 2;         // 53,248 bytes
constexpr int kSmemCells = kTileRows * kCells;     // 3,328 bytes
constexpr int kSmemBytes = kSmemG + kSmemCells;    // 56,576 bytes

__device__ __forceinline__ void add_lane(const __nv_bfloat16* sG, int lane_row,
                                         int h0, float rv, float z[4]) {
  const uint2 raw =
      *reinterpret_cast<const uint2*>(sG + lane_row * kHidden + h0);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  z[0] = fmaf(rv, lo.x, z[0]);
  z[1] = fmaf(rv, lo.y, z[1]);
  z[2] = fmaf(rv, hi.x, z[2]);
  z[3] = fmaf(rv, hi.y, z[3]);
}

__global__ void __launch_bounds__(kThreads)
fused_value_kernel(const int8_t* __restrict__ cells,
                   const int8_t* __restrict__ flag,
                   const __nv_bfloat16* __restrict__ G,
                   const float* __restrict__ b1p,
                   const float* __restrict__ tflip,
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2,
                   float* __restrict__ out,
                   long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* sCells = reinterpret_cast<int8_t*>(smem + kSmemG);

  // G once per CTA, in 16-byte words (the wrapper guarantees alignment).
  const int4* gsrc = reinterpret_cast<const int4*>(G);
  int4* gdst = reinterpret_cast<int4*>(sG);
  for (int i = threadIdx.x; i < kSmemG / 16; i += kThreads) gdst[i] = gsrc[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h0 = lane * 4;
  float bias0[4], bias1[4], w2f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias0[j] = b1p[h0 + j];
    bias1[j] = b1p[h0 + j] + tflip[h0 + j];
    w2f[j] = __bfloat162float(w2[h0 + j]);
  }
  const float b2v = b2[0];

  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // G staged; the previous tile's rows all read
    const long long row0 = tile * kTileRows;
    const long long left = n - row0;
    const int rows = left < kTileRows ? (int)left : kTileRows;
    const int nbytes = rows * kCells;
    const int8_t* src = cells + row0 * kCells;
    for (int i = threadIdx.x; i < kSmemCells; i += kThreads)
      sCells[i] = i < nbytes ? src[i] : (int8_t)0;
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      const int8_t* row = sCells + r * kCells;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < kPointCells; ++c) {
        const int cnt = row[c];
        const int nk = cnt < 4 ? cnt : 4;  // nonzero lanes of r for this cell
        for (int k = 0; k < nk; ++k)
          add_lane(sG, 4 * c + k, h0, (float)(cnt - k), z);
      }
      // bar/off cells are linear: only their k = 0 lane has a nonzero G row
      for (int c = kPointCells; c < kCells; ++c) {
        const int cnt = row[c];
        if (cnt > 0) add_lane(sG, 4 * c, h0, (float)cnt, z);
      }
      const bool f = flag[row0 + r] != 0;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float zz = z[j] + (f ? bias1[j] : bias0[j]);
        const float hid = 1.0f / (1.0f + expf(-zz));
        const float hb = __bfloat162float(__float2bfloat16_rn(hid));
        part = fmaf(hb, w2f[j], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) out[row0 + r] = part + b2v;
    }
  }
}

}  // namespace

extern "C" {

// Hidden width the kernel is compiled for; the wrapper checks the params.
int fused_value_hidden() { return kHidden; }

// Launch on `stream`. Pointers are device pointers: cells int8 [n, 52],
// flag int8 [n], G bf16 [208, 128] (16-byte aligned), b1p f32 [128],
// tflip f32 [128], w2 bf16 [128], b2 f32 [1], out f32 [n].
// Returns cudaGetLastError() after the launch (0 on success).
int fused_value_launch(const void* cells, const void* flag, const void* G,
                       const void* b1p, const void* tflip, const void* w2,
                       const void* b2, void* out, long long n, void* stream) {
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
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  const long long slots = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(ntiles < slots ? ntiles : slots);
  fused_value_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)cells, (const int8_t*)flag, (const __nv_bfloat16*)G,
      (const float*)b1p, (const float*)tflip, (const __nv_bfloat16*)w2,
      (const float*)b2, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
