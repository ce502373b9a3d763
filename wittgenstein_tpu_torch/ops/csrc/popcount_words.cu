// popcount_words: total set bits of each packed row, [M, w] uint32 -> [M] int32.
//
// Replaces the TPU kernel popcount_words_pallas / _popcount_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py (SWAR count per word, then a row
// sum over a row block held whole in VMEM).
//
// Bound on the H100: bytes.  Each word is read once and costs one __popc
// and one add, far below the card's integer rate, so the kernel can at
// best stream the M*w words from HBM.  The design keeps every warp's loads
// coalesced whatever the row width: a group of TPR lanes (a power of two,
// at most 32 and at most w) shares one row and strides over its words, so
// one warp step reads 32 consecutive words — 32/TPR whole rows for narrow
// rows, one 128-byte slice of a row for wide ones — and the group sums
// with warp shuffles.  A grid-stride loop over warp steps covers any M.
#include <cuda_runtime.h>
#include <stdint.h>

template <int TPR>
__global__ void popcount_rows(const uint32_t* __restrict__ words,
                              int32_t* __restrict__ out, long long m, int w) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  // the loop bound depends on the warp only, so every lane of a warp runs
  // the same iterations and the full-mask shuffles below are legal
  for (long long base = warp * kRowsPerWarp; base < m; base += n_warps * kRowsPerWarp) {
    const long long row = base + lane / TPR;
    int c = 0;
    if (row < m) {
      const uint32_t* p = words + row * (long long)w;
      for (int j = sub; j < w; j += TPR) c += __popc(__ldg(p + j));
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off, TPR);
    if (row < m && sub == 0) out[row] = c;
  }
}

template <int TPR>
static void launch(const uint32_t* words, int32_t* out, long long m, int w,
                   cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (m * TPR + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond ~60 blocks per SM
  popcount_rows<TPR><<<(unsigned)blocks, threads, 0, stream>>>(words, out, m, w);
}

extern "C" int witt_popcount_words(const void* words, void* out, long long m,
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
