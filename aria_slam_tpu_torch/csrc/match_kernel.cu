// Brute-force Hamming kNN-2 for Hopper (sm_90a).
//
// Replaces the Pallas kernel aria_slam_tpu/ops/pallas/match_kernel.py
// (_match_kernel, reached through match_top2_batched). Same function:
// for N pairs of {0,1} int8 descriptor sets (N, Kq, 256) and (N, Kt, 256)
// with a train validity mask (N, Kt), the best and second Hamming
// distance and the best train index of every query, each (N, Kq) int32,
// without materialising the Kq x Kt distance matrix. The rules kept
// exactly: an invalid train column has distance 1<<20; distances are
// clipped at 1024 and a clipped value reports as 1<<20; ties go to the
// lowest train index; `second` is the minimum over every column except
// the best one (a duplicate of the best gives second == best); an
// all-invalid train set gives index 0 and best = second = 1<<20; Kt = 1
// gives second = 1<<20.
//
// What bounds it on this card: operations. A pair costs Kq * Kt * 256
// bit comparisons on about 1 MB of input; counted as an int8 product
// (2 operations per bit pair) that is 2.05 GOP at Kq = Kt = 2000.
//
// Design: descriptors are packed on the fly into 8 x uint32 words, bit b
// of word w = byte 32 w + b (the bit order of ops/brief.py pack_bits),
// from 16-byte loads. A block owns QB queries; each query's 8 words stay
// in registers. Train descriptors stream through shared memory in tiles
// of TT, packed while they are staged. The block's 4 warps groups split
// each tile's columns 4 ways (column j goes to group j % 4), each thread
// keeps (best, best index, second) for its query over its columns in
// ascending order, and the four partial results are merged at the end
// in shared memory: the lexicographically smaller (best, index) wins and
// second = min(winner's second, loser's best).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;           // 256 bits
constexpr int QB = 64;             // queries per block
constexpr int SPLIT = 4;           // column groups per block
constexpr int THREADS = QB * SPLIT;
constexpr int TT = 256;            // train descriptors per shared tile
constexpr int BIG = 1 << 20;
constexpr int CLIP = 1 << 10;
constexpr int NONE = 0x7FFFFFFF;

// 32 {0,1} bytes (two 16-byte loads) -> one word, bit b = byte b != 0
__device__ __forceinline__ uint32_t pack32(const int8_t* p) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 16);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t n = __vcmpne4(w[k], 0u) & 0x01010101u;  // one bit per byte
    out |= ((n | (n >> 7) | (n >> 14) | (n >> 21)) & 0xFu) << (4 * k);
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const int8_t* __restrict__ desc_q, const int8_t* __restrict__ desc_t,
                  const uint8_t* __restrict__ valid_t, int* __restrict__ best,
                  int* __restrict__ second, int* __restrict__ best_idx, int Kq, int Kt) {
  __shared__ uint32_t s_t[TT][WORDS];
  __shared__ uint8_t s_valid[TT];
  __shared__ int m_best[SPLIT][QB], m_idx[SPLIT][QB], m_second[SPLIT][QB];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % QB, group = threadIdx.x / QB;
  const int qi = blockIdx.x * QB + lane;
  const bool active = qi < Kq;

  uint32_t q[WORDS];
  if (active) {
    const int8_t* p = desc_q + ((size_t)n * Kq + qi) * (WORDS * 32);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) q[w] = pack32(p + 32 * w);
  }

  int b_val = NONE, b_idx = 0, s_val = NONE;
  const int8_t* tbase = desc_t + (size_t)n * Kt * (WORDS * 32);
  for (int t0 = 0; t0 < Kt; t0 += TT) {
    const int nt = min(TT, Kt - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nt * WORDS; i += THREADS)
      s_t[i / WORDS][i % WORDS] = pack32(tbase + ((size_t)t0 * WORDS + i) * 32);
    for (int i = threadIdx.x; i < nt; i += THREADS)
      s_valid[i] = valid_t[(size_t)n * Kt + t0 + i];
    __syncthreads();
    if (active) {
      for (int j = group; j < nt; j += SPLIT) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) d += __popc(q[w] ^ s_t[j][w]);
        const int v = s_valid[j] ? d : CLIP;  // min(distance, CLIP); d <= 256
        if (v < b_val) {
          s_val = b_val;
          b_val = v;
          b_idx = t0 + j;
        } else {
          s_val = min(s_val, v);
        }
      }
    }
  }

  m_best[group][lane] = b_val;
  m_idx[group][lane] = b_idx;
  m_second[group][lane] = s_val;
  __syncthreads();
  if (group != 0 || !active) return;
  for (int g = 1; g < SPLIT; ++g) {
    const int ob = m_best[g][lane], oi = m_idx[g][lane], os = m_second[g][lane];
    if (ob < b_val || (ob == b_val && oi < b_idx)) {
      s_val = min(os, b_val);
      b_val = ob;
      b_idx = oi;
    } else {
      s_val = min(s_val, ob);
    }
  }
  const size_t o = (size_t)n * Kq + qi;
  best[o] = b_val >= CLIP ? BIG : b_val;
  second[o] = s_val >= CLIP ? BIG : s_val;
  best_idx[o] = b_idx;
}

}  // namespace

extern "C" int match_top2_launch(const void* desc_q, const void* desc_t, const void* valid_t,
                                 void* best, void* second, void* best_idx,
                                 int N, int Kq, int Kt, void* stream) {
  if (N < 1 || Kq < 1 || Kt < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Kq + QB - 1) / QB, N);
  match_top2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)desc_q, (const int8_t*)desc_t, (const uint8_t*)valid_t,
      (int*)best, (int*)second, (int*)best_idx, Kq, Kt);
  return (int)cudaGetLastError();
}
