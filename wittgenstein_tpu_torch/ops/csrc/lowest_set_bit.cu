// lowest_set_bit: index of the lowest set bit of each packed row,
// [M, w] uint32 -> [M] int32, 32 for an all-zero row.
//
// Replaces the TPU kernel lowest_set_bit_pallas / _lowest_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py, which builds a per-word
// candidate (SWAR popcount of low-1) and takes a min over the row.  Here
// the candidate is 32*j + __ffs(word) - 1 for the first nonzero word j.
//
// Bound on the H100: bytes (one pass over the words at most; a lane stops
// at its first nonzero word).  Same layout as popcount_words.cu: TPR lanes
// share a row and stride over its words, so a warp's loads are 32
// consecutive words; each lane keeps the candidate of its first nonzero
// word (its smallest, since its words ascend) and the group takes the min
// with warp shuffles.  An empty row yields 32, the value the JAX
// package's lax path gives (its argmax lands on word 0, whose (0 & -0)-1
// has 32 bits set) — callers gate on popcount > 0.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

template <int TPR>
__global__ void lowest_rows(const uint32_t* __restrict__ words,
                            int32_t* __restrict__ out, long long m, int w) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * kRowsPerWarp; base < m; base += n_warps * kRowsPerWarp) {
    const long long row = base + lane / TPR;
    int best = INT_MAX;
    if (row < m) {
      const uint32_t* p = words + row * (long long)w;
      for (int j = sub; j < w; j += TPR) {
        const uint32_t v = __ldg(p + j);
        if (v != 0u) {
          best = 32 * j + __ffs((int)v) - 1;
          break;
        }
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off, TPR));
    if (row < m && sub == 0) out[row] = (best == INT_MAX) ? 32 : best;
  }
}

template <int TPR>
static void launch(const uint32_t* words, int32_t* out, long long m, int w,
                   cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (m * TPR + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  lowest_rows<TPR><<<(unsigned)blocks, threads, 0, stream>>>(words, out, m, w);
}

extern "C" int witt_lowest_set_bit(const void* words, void* out, long long m,
                                   int w, void* stream) {
  const uint32_t* in = static_cast<const uint32_t*>(words);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w >= 32) launch<32>(in, o, m, w, s);
  else if (w >= 16) launch<16>(in, o, m, w, s);
  else if (w >= 8) launch<8>(in, o, m, w, s);
  else if (w >= 4) launch<4>(in, o, m, w, s);
  else if (w >= 2) launch<2>(in, o, m, w, s);
  else launch<1>(in, o, m, w, s);
  return (int)cudaGetLastError();
}
