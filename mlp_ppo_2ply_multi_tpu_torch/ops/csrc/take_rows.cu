// take_rows: a per-game row take, out[n, k] = boards[n, idx[n, k]].
//
// Replaces the three TPU kernels of scripts/probe_pallas_batched_dot.py that
// compute this function: take_pallas (:55, a one-hot bf16 [R, K, W] built
// outside the kernel, then a batched dot or a loop of 2-D dots), take_pallas_fused
// (:86, the one-hot built inside the kernel) and take_bdiag (:214, r games as
// one block-diagonal one-hot product). They are ways to make the TPU's matrix
// unit do a take. Here the same function is a byte gather.
//
// Contract: boards int8 [N, W, C] with C a multiple of 4, idx int32 or int64
// [N, K], out int8 [N, K, C], all contiguous and 4-byte aligned. An index
// outside [0, W) gives a zero row (the one-hot of P1/P2 with no match); the
// kernel never reads outside game n's table.
//
// Bound: bytes. It does no arithmetic beyond addresses; at the probe's shape
// (N = 4096, K = W = 128, C = 52) it moves ~47 MB: the source rows used once,
// the indices, and N * K * C bytes written. Design (simple first): one thread
// per 32-bit output word, grid-stride. Neighbouring threads write
// neighbouring words, so the stores coalesce; the 13 threads of one output
// row read the same index (one transaction) and the source words through the
// read-only path. Staging each game's table in shared memory (cp.async or
// TMA) is left for a redesign once a benchmark shows it matters.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const uint32_t* __restrict__ boards, const Index* __restrict__ idx,
                 uint32_t* __restrict__ out, unsigned total, unsigned k, unsigned w,
                 unsigned cw) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const unsigned row = t / cw;  // n * k + j
    const unsigned word = t - row * cw;
    const unsigned n = row / k;
    const long long src = static_cast<long long>(__ldg(idx + row));
    uint32_t v = 0u;
    if (src >= 0 && src < static_cast<long long>(w)) {
      v = __ldg(boards + (static_cast<size_t>(n) * w + static_cast<size_t>(src)) * cw + word);
    }
    out[t] = v;
  }
}

}  // namespace

// Launch on ``stream``: ``n`` games, ``w`` table rows a game, ``k`` output
// rows a game, ``cw`` 32-bit words a row, ``idx_bytes`` 4 (int32) or 8
// (int64). The caller keeps n * k * cw and n * w * cw below 2^31. Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int take_rows_launch(const void* boards, const void* idx, int idx_bytes, void* out,
                                long long n, int w, int k, int cw, void* stream) {
  const long long total = n * k * cw;
  if (total <= 0) return 0;
  const long long blocks_needed = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const uint32_t*>(boards);
  auto* o = static_cast<uint32_t*>(out);
  if (idx_bytes == 8) {
    take_rows_kernel<long long><<<blocks, kThreads, 0, s>>>(
        b, static_cast<const long long*>(idx), o, static_cast<unsigned>(total),
        static_cast<unsigned>(k), static_cast<unsigned>(w), static_cast<unsigned>(cw));
  } else {
    take_rows_kernel<int><<<blocks, kThreads, 0, s>>>(
        b, static_cast<const int*>(idx), o, static_cast<unsigned>(total),
        static_cast<unsigned>(k), static_cast<unsigned>(w), static_cast<unsigned>(cw));
  }
  return static_cast<int>(cudaGetLastError());
}
