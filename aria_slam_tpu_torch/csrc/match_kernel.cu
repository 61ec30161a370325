// Brute-force Hamming kNN-2 on the int8 tensor cores, for Hopper (sm_90a).
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
// multiply-adds of int8 {0,1} values on about 1 MB of input: 2.05 GOP at
// Kq = Kt = 2000, 1 us at the int8 tensor-core peak.
//
// Design:
// - Distances as the reference computes them on the MXU: dot = q . t on
//   the tensor cores (mma.sync m16n8k32 s8 x s8 -> s32, exact), then
//   dist = popcount(q) + popcount(t) - 2 dot. An invalid column (and a
//   padding column past Kt) gets the popcount stand-in 2048, so that
//   min(dist, 1024) = 1024: the clip rule. Padding columns are exact
//   stand-ins for invalid ones: their index is above every real column,
//   so they never win a tie, and a `second` >= 1024 reports 1<<20 either
//   way.
// - A block owns 128 queries (two 16-row MMA tiles per warp, their A
//   fragments in registers for the whole run, so that each B fragment
//   read from shared memory feeds two MMAs) and one slice of the train
//   columns. Train tiles of 64 rows stream through shared memory with
//   cp.async, double-buffered, in rows padded to 272 bytes so that
//   ldmatrix reads them without bank conflicts; their popcounts are taken
//   from shared memory as each tile lands.
// - Each thread keeps the two smallest packed keys (min(dist, 1024) << 20
//   | column, the reference's packing: ties go to the lower column) of
//   its four query rows (two a tile), in two chains a row (even and odd
//   columns) for instruction-level parallelism: best = min(best, key),
//   second = min(second, max(best, key)), no branches. The chains, the
//   quad's four threads and then the slices merge the same way: best =
//   min of the bests, second = min(min of the seconds, max of the bests).
// - The wrapper splits the train columns into S slices so that even
//   N = 1 fills every SM; with S > 1 the blocks write partial results
//   to scratch and a second small kernel merges the S partials per query.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BYTES = 256;             // descriptor bytes: the K of the product
constexpr int KSTEPS = BYTES / 32;     // m16n8k32 steps
constexpr int WARPS = 4;
constexpr int MT = 2;                  // 16-row MMA tiles (queries) per warp
constexpr int QB = 16 * MT * WARPS;    // queries per block
constexpr int THREADS = 32 * WARPS;
constexpr int TT = 64;                 // train rows per shared-memory stage
constexpr int NTILES = TT / 8;         // m16n8 column tiles per stage
constexpr int NP = 4;                  // column tiles per pass (accumulators live)
constexpr int ROW = BYTES + 16;        // padded shared row, bytes
constexpr int BIG = 1 << 20;
constexpr int CLIP = 1 << 10;
constexpr int INVALID_POP = 2 * CLIP;  // pq + 2048 - 2 dot >= 1792 > CLIP
constexpr int IDX_BITS = 20;           // packed key: distance << 20 | column
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int NONE = 0x7FFFFFFF;       // no column yet
constexpr int ONES = 0x01010101;
static_assert(THREADS == 2 * TT, "two threads count each staged row");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled where src_bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices: lane l gets row l/4, bytes 4 (l%4) .. +3 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Packed keys (distance << 20 | column), as the reference packs them: the
// smaller key is the smaller distance, ties to the lower column. A Top2
// holds the two smallest keys seen; `second` carries its own column, so
// it is the smallest key of every column but the best one.
struct Top2 {
  int best, second;
};


__device__ __forceinline__ void push(Top2& s, int key) {
  s.second = min(s.second, max(s.best, key));
  s.best = min(s.best, key);
}

__device__ __forceinline__ void merge(Top2& s, const Top2& o) {
  s.second = min(min(s.second, o.second), max(s.best, o.best));
  s.best = min(s.best, o.best);
}

__device__ __forceinline__ int reported(int key) {
  const int v = key >> IDX_BITS;
  return v >= CLIP ? BIG : v;
}

__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const int8_t* __restrict__ desc_q, const int8_t* __restrict__ desc_t,
                  const uint8_t* __restrict__ valid_t, int* __restrict__ best,
                  int* __restrict__ second, int* __restrict__ best_idx,
                  int* __restrict__ part_best, int* __restrict__ part_second, int Kq, int Kt,
                  int slice_len) {
  __shared__ __align__(16) int8_t s_t[2][TT][ROW];
  __shared__ int s_pop[2][TT];  // train popcounts, INVALID_POP for invalid columns

  const int n = blockIdx.z, slice = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // this thread's query rows: row0 + 16 m + 8 h, m < MT, h < 2
  const int row0 = blockIdx.x * QB + warp * 16 * MT + g;

  const int col_begin = slice * slice_len;
  const int ntiles = (min(slice_len, Kt - col_begin) + TT - 1) / TT;
  const int8_t* tbase = desc_t + (size_t)n * Kt * BYTES;
  const uint8_t* vbase = valid_t + (size_t)n * Kt;

  // 16-byte cp.async chunks of train tile `tile`; rows past Kt are zeros
  auto stage = [&](int tile, int buf) {
    const int c0 = col_begin + tile * TT;
    for (int i = threadIdx.x; i < TT * (BYTES / 16); i += THREADS) {
      const int r = i / (BYTES / 16), chunk = i % (BYTES / 16);
      const bool in = c0 + r < Kt;
      cp_async16(&s_t[buf][r][16 * chunk],
                 tbase + (size_t)(in ? c0 + r : 0) * BYTES + 16 * chunk, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // the validity of staged row threadIdx.x / 2 of tile `tile`
  auto row_valid = [&](int tile) {
    const int col = col_begin + tile * TT + threadIdx.x / 2;
    return col < Kt && vbase[col] != 0;
  };

  // tile 0 and its validity are in flight while the A fragments load
  stage(0, 0);
  bool valid_now = row_valid(0);

  // A fragments of the warp's 16 MT queries, all 256 bytes: a[m][kk] =
  // rows 16 m + g, + 8 at bytes 32 kk + 4 tq and 32 kk + 16 + 4 tq
  uint32_t a[MT][KSTEPS][4];
  const int8_t* qbase = desc_q + (size_t)n * Kq * BYTES;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * m + 8 * h;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(qbase + (size_t)row * BYTES) + tq;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        a[m][kk][h] = row < Kq ? __ldg(p + 8 * kk) : 0u;
        a[m][kk][h + 2] = row < Kq ? __ldg(p + 8 * kk + 4) : 0u;
      }
    }
  }
  // query popcounts: the quad's four threads hold all 256 bytes of a row
  int pq[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int c = 0;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        c = __dp4a((int)a[m][kk][h], ONES, __dp4a((int)a[m][kk][h + 2], ONES, c));
      c += __shfl_xor_sync(0xFFFFFFFFu, c, 1);
      pq[m][h] = c + __shfl_xor_sync(0xFFFFFFFFu, c, 2);
    }
  }

  // st[m][h][e]: row 16 m + 8 h over the columns of parity e (two chains a row)
  Top2 st[MT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) st[m][h][0] = st[m][h][1] = Top2{NONE, NONE};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int c0 = col_begin + it * TT;
    bool valid_next = false;
    if (it + 1 < ntiles) {
      stage(it + 1, buf ^ 1);
      valid_next = row_valid(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // train popcounts of the staged rows: two threads a row, 128 bytes each
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      const int4* p = reinterpret_cast<const int4*>(&s_t[buf][r][128 * half]);
      int pop = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int4 w = p[j];
        pop = __dp4a(w.x, ONES, __dp4a(w.y, ONES, __dp4a(w.z, ONES, __dp4a(w.w, ONES, pop))));
      }
      pop += __shfl_xor_sync(0xFFFFFFFFu, pop, 1);
      if (half == 0) s_pop[buf][r] = valid_now ? pop : INVALID_POP;
    }
    __syncthreads();

    // the tile's column tiles in passes of NP: each B fragment feeds MT MMAs
#pragma unroll
    for (int j0 = 0; j0 < NTILES; j0 += NP) {
      int acc[MT][NP][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NP; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0;
#pragma unroll
      for (int kq = 0; kq < KSTEPS / 2; ++kq) {
        // matrices 0..3 of column tile j: k bytes 64 kq + 16 i of train rows 8 j .. 8 j + 7
        uint32_t b[NP][4];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          ldmatrix_x4(b[j], &s_t[buf][8 * (j0 + j) + (lane & 7)][64 * kq + 16 * (lane >> 3)]);
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_s8(acc[m][j], a[m][2 * kq], b[j][0], b[j][1]);
            mma_s8(acc[m][j], a[m][2 * kq + 1], b[j][2], b[j][3]);
          }
      }
      // accumulator (row 16 m + g + 8 h, column 8 j + 2 tq + e) -> running top-2
#pragma unroll
      for (int j = 0; j < NP; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = 8 * (j0 + j) + 2 * tq + e;
          const int pt = s_pop[buf][lc];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int dist = min(pq[m][h] + pt - 2 * acc[m][j][2 * h + e], CLIP);
              push(st[m][h][e], (dist << IDX_BITS) | (c0 + lc));
            }
        }
      }
    }
    __syncthreads();  // this buffer is staged again two tiles on
    valid_now = valid_next;
  }

  // merge the two parities, then the quad's threads (same rows, other columns)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2& r = st[m][h][0];
      merge(r, st[m][h][1]);
#pragma unroll
      for (int off = 1; off <= 2; off *= 2)
        merge(r, Top2{__shfl_xor_sync(0xFFFFFFFFu, r.best, off),
                      __shfl_xor_sync(0xFFFFFFFFu, r.second, off)});
      const int row = row0 + 16 * m + 8 * h;
      if (tq != 0 || row >= Kq) continue;
      if (part_best) {  // partials (N, S, Kq), merged by merge_slices_kernel
        const size_t o = ((size_t)n * gridDim.y + slice) * Kq + row;
        part_best[o] = r.best;
        part_second[o] = r.second;
      } else {
        const size_t o = (size_t)n * Kq + row;
        best[o] = reported(r.best);
        second[o] = reported(r.second);
        best_idx[o] = r.best & IDX_MASK;
      }
    }
  }
}

__global__ void merge_slices_kernel(const int* __restrict__ part_best,
                                    const int* __restrict__ part_second,
                                    int* __restrict__ best, int* __restrict__ second,
                                    int* __restrict__ best_idx, int N, int S, int Kq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * Kq) return;
  const int n = i / Kq, q = i - n * Kq;
  size_t o = (size_t)n * S * Kq + q;
  Top2 st = {part_best[o], part_second[o]};
  for (int s = 1; s < S; ++s) {
    o += Kq;
    merge(st, Top2{part_best[o], part_second[o]});
  }
  best[i] = reported(st.best);
  second[i] = reported(st.second);
  best_idx[i] = st.best & IDX_MASK;
}

}  // namespace

// slices * slice_len covers Kt with no empty slice; slice_len is a
// multiple of 64 (TT) and every padded column index fits 20 bits. With
// slices > 1 the part_* buffers hold (N, slices, Kq) int32 keys each.
extern "C" int match_top2_launch(const void* desc_q, const void* desc_t, const void* valid_t,
                                 void* best, void* second, void* best_idx, void* part_best,
                                 void* part_second, int N, int Kq, int Kt, int slices,
                                 int slice_len, void* stream) {
  if (N < 1 || Kq < 1 || Kt < 1 || N > 65535 || slices < 1 || slices > 65535 ||
      slice_len < TT || slice_len % TT != 0 || (long long)slices * slice_len < Kt ||
      (long long)(slices - 1) * slice_len >= Kt ||
      (long long)slices * slice_len > (1LL << IDX_BITS) || (long long)N * Kq > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (slices > 1 && (!part_best || !part_second)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((Kq + QB - 1) / QB, slices, N);
  const bool direct = slices == 1;
  match_top2_kernel<<<grid, THREADS, 0, s>>>(
      (const int8_t*)desc_q, (const int8_t*)desc_t, (const uint8_t*)valid_t, (int*)best,
      (int*)second, (int*)best_idx, direct ? nullptr : (int*)part_best,
      direct ? nullptr : (int*)part_second, Kq, Kt, slice_len);
  if (direct) return (int)cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = N * Kq;
  merge_slices_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      (const int*)part_best, (const int*)part_second, (int*)best, (int*)second,
      (int*)best_idx, N, slices, Kq);
  return (int)cudaGetLastError();
}
