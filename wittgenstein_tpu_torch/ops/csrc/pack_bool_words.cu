// pack_bool_words: pack each row of bools into 32-bit words,
// [M, W] bool (one byte each) -> [M, ceil(W/32)] uint32, bit j of word k
// = element 32k + j, the padding bits past W zero.
//
// Replaces the TPU kernel pack_bool_words_pallas / _pack_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py, which pads the bit axis to a
// word multiple in VMEM and forms each word as a weighted sum of 32 bools.
//
// Bound on the H100: bytes (W bytes read and W/8 bytes written per row;
// one compare per element).  One warp builds one output word: lane j
// reads byte 32k + j of its row (0 past W), so a warp's load is 32
// consecutive bytes, and __ballot_sync gathers the 32 predicates into the
// word in one instruction; lane 0 stores it.  A grid-stride loop walks the
// M * ceil(W/32) words; its bound depends on the warp only, so every lane
// of a warp stays in the loop together and the full-mask ballot is legal
// on a ragged M.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pack_rows(const uint8_t* __restrict__ bits,
                          uint32_t* __restrict__ out, long long m, int w,
                          int nw) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  const long long total = m * (long long)nw;
  for (long long o = warp; o < total; o += n_warps) {
    const long long row = o / nw;
    const int col = (int)(o - row * nw) * 32 + lane;
    const uint8_t b = col < w ? __ldg(bits + row * (long long)w + col) : 0;
    const uint32_t word = __ballot_sync(0xffffffffu, b != 0);
    if (lane == 0) out[o] = word;
  }
}

extern "C" int witt_pack_bool_words(const void* bits, void* out, long long m,
                                    int w, void* stream) {
  const int nw = (w + 31) / 32;
  const int threads = 256;
  long long blocks = (m * nw * 32 + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;
  pack_rows<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(out), m, w, nw);
  return (int)cudaGetLastError();
}
