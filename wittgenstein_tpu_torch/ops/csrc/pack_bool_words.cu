// pack_bool_words: pack each row of W elements into 32-bit words, bit j of
// word k = element 32k + j, the padding bits past W zero.  Two forms:
//
//   witt_pack_bool_words(bits)        [M, W] bool (one byte each)
//                                     -> [M, ceil(W/32)] uint32; any
//                                     nonzero byte is a set bit
//   witt_pack_occupied(fill, shift)   [M, W] int32 -> the same words of
//                                     the row rotated left by shift and
//                                     tested > 0: element i of the packed
//                                     row is fill[(i + shift) mod W] > 0
//
// Replaces the TPU kernel pack_bool_words_pallas / _pack_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py, which pads the bit axis to a word
// multiple in VMEM and forms each word as a weighted sum of 32 bools.  The
// engine's wheel-occupancy sites feed it roll(whl_fill > 0, -shift): two
// torch passes over the int32 fill before the pack.  pack_occupied reads
// the fill once, in place, and does the test, the rotation and the pack.
//
// Bound on the H100: bytes.  pack_bool_words reads W bytes and writes W/8
// a row; pack_occupied reads 4W bytes and writes W/8.
//
// Both forms walk one row per warp; the loop bounds depend on the warp
// only, so every lane reaches every full-mask ballot and shuffle, and no
// word divides its index.
//
// pack_bool_words: 128 elements a step.  Lane j takes the four bytes at
// 128 s + 4 j from the aligned 4-byte word that holds the first (and the
// next one where the row starts off a 4-byte boundary, shifted into place
// by a funnel shift), so any W and any base take the one path.  A
// carry-free add marks each nonzero byte's top bit and one multiply
// gathers the four in order; the eight lanes of a word OR their nibbles
// together by shuffles.  4 steps in flight read a wheel row of 512 bytes
// in one round trip.
//
// pack_occupied: 32 elements a step; lane j votes for element 32 k + j (0
// past W) and __ballot_sync forms word k.  Lane j keeps the words k = j
// mod 32 and the warp stores them 32 at a time.  The votes of 16 steps are
// loaded before their ballots, so a warp reads a wheel row of 512 int32 in
// one round trip; a step reads 128 contiguous bytes of the fill except
// where it wraps at W.
#include "rows.cuh"

// Bit i of the result: byte i of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t x) {
  // (b & 0x7f) + 0x7f reaches 0x80 iff the low seven bits are not all
  // zero and never carries out of its byte; | b adds b's own top bit
  const uint32_t top = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  // bits 7, 15, 23, 31 -> bits 28, 29, 30, 31: the ten partial products
  // land on distinct bits, so nothing carries
  return (top * 0x00204081u) >> 28;
}

constexpr int kByteStepsInFlight = 4;

__global__ void pack_byte_rows(const uint8_t* __restrict__ bits, uint32_t* __restrict__ out,
                               long long m, int w) {
  const int lane = threadIdx.x & 31;
  const int nw = (w + 31) / 32;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long row = warp; row < m; row += n_warps) {
    const uint8_t* src = bits + row * w;
    const int a = (int)((uintptr_t)src & 3);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(src - a);
    // the aligned words q[0 .. nd) each hold at least one byte of the row
    const int nd = (a + w + 3) / 4;
    uint32_t* dst = out + row * nw;
    for (int s0 = 0; 128 * s0 < w; s0 += kByteStepsInFlight) {
      uint32_t lo[kByteStepsInFlight], hi[kByteStepsInFlight];
#pragma unroll
      for (int i = 0; i < kByteStepsInFlight; ++i) {
        const int d = 32 * (s0 + i) + lane;
        lo[i] = d < nd ? __ldg(q + d) : 0;
        hi[i] = a != 0 && d + 1 < nd ? __ldg(q + d + 1) : 0;
      }
#pragma unroll
      for (int i = 0; i < kByteStepsInFlight; ++i) {
        // elements col .. col + 3; those at W and past it vote 0
        const int valid = w - (128 * (s0 + i) + 4 * lane);
        uint32_t nib = nonzero_nibble(__funnelshift_r(lo[i], hi[i], 8 * a));
        if (valid < 4) nib &= valid > 0 ? (1u << valid) - 1u : 0u;
        uint32_t part = nib << (4 * (lane & 7));
        part |= __shfl_xor_sync(0xffffffffu, part, 1);
        part |= __shfl_xor_sync(0xffffffffu, part, 2);
        part |= __shfl_xor_sync(0xffffffffu, part, 4);
        const int k = 4 * (s0 + i) + (lane >> 3);
        if ((lane & 7) == 0 && k < nw) dst[k] = part;
      }
    }
  }
}

constexpr int kStepsInFlight = 16;

// One warp packs the row at src (W elements) into its nw words at dst;
// vote(src, i) is element i's bit, read only for i < W.
template <typename T, typename Vote>
__device__ __forceinline__ void pack_row(const T* __restrict__ src, uint32_t* __restrict__ dst,
                                         int w, int nw, int lane, Vote vote) {
  uint32_t mine = 0;
  for (int k0 = 0; k0 < nw; k0 += kStepsInFlight) {
    bool bit[kStepsInFlight];
#pragma unroll
    for (int i = 0; i < kStepsInFlight; ++i) {
      const int col = 32 * (k0 + i) + lane;
      bit[i] = col < w && vote(src, col);
    }
#pragma unroll
    for (int i = 0; i < kStepsInFlight; ++i) {
      const int k = k0 + i;
      const uint32_t word = __ballot_sync(0xffffffffu, bit[i]);
      const int slot = k & 31;
      if (k < nw) {
        if (slot == lane) mine = word;
        // lanes 0..slot hold words k - slot .. k
        if ((slot == 31 || k == nw - 1) && lane <= slot) dst[k - slot + lane] = mine;
      }
    }
  }
}

// element i of the packed row is fill[(i + shift) mod W] > 0; shift < W
struct OccupiedRotated {
  int shift;
  int w;
  __device__ bool operator()(const int32_t* row, int i) const {
    int j = i + shift;
    if (j >= w) j -= w;
    return __ldg(row + j) > 0;
  }
};

// A warp per row, grid-stride over the m rows.
template <typename T, typename Vote>
__device__ __forceinline__ void pack_rows(const T* __restrict__ src, uint32_t* __restrict__ out,
                                          long long m, int w, Vote vote) {
  const int lane = threadIdx.x & 31;
  const int nw = (w + 31) / 32;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long row = warp; row < m; row += n_warps)
    pack_row(src + row * w, out + row * nw, w, nw, lane, vote);
}

__global__ void pack_occupied_rows(const int32_t* __restrict__ fill,
                                   uint32_t* __restrict__ out, long long m, int w, int shift) {
  pack_rows(fill, out, m, w, OccupiedRotated{shift, w});
}

extern "C" int witt_pack_bool_words(const void* bits, void* out, long long m, int w,
                                    void* stream) {
  if (m == 0) return 0;
  pack_byte_rows<<<grid_for(m * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(out), m, w);
  return (int)cudaGetLastError();
}

extern "C" int witt_pack_occupied(const void* fill, void* out, long long m, int w, int shift,
                                  void* stream) {
  if (m == 0) return 0;
  pack_occupied_rows<<<grid_for(m * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fill), static_cast<uint32_t*>(out), m, w, shift);
  return (int)cudaGetLastError();
}
