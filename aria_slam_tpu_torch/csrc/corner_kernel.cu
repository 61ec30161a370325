// FAST-9 + 3x3 NMS + Harris corner rank maps for Hopper (sm_90a), every
// pyramid level of every frame in one launch.
//
// Replaces the Pallas kernel aria_slam_tpu/ops/pallas/corner_kernel.py
// (_corner_rank_kernel, reached through corner_rank_map_batched). Same
// function, per level: for every pixel of a (B, H, W) float32 image,
// computed on the image edge-replicated in every direction, the Harris
// response (3x3 Sobel, box sum of the gradient products, det - k tr^2)
// where an NMS-surviving FAST-9 corner sits (16-px ring, 9-long arc,
// margin over the threshold), and -3e38 elsewhere.
//
// What bounds it on this card: counted as the plain version does them,
// each output pixel costs about 400 float32 operations (FAST alone 320)
// against 8 bytes of device traffic, far above the card's 20 float
// operations per byte of bandwidth. Done the cheapest way known (the cuts
// below; chip_smoke.py corner_ops counts them on the data), the work
// shrinks to far fewer operations a pixel, and device memory bounds the
// function. The pyramid's small levels cannot fill the card one launch at
// a time, so latency and tails held a one-launch-per-level design back.
//
// Design:
// - One launch for all levels: the grid flattens (frame, level, tile).
//   The level table arrives by value; a block finds its level from the
//   prefix sums of tiles per level and clamps against that level's H, W.
// - A 32x32 output tile and 256 threads. The block stages the tile with a
//   5-px halo of the edge-clamped image (42x42, 1.72x the tile's pixels)
//   in shared memory once; everything after reads shared memory.
// - Work where the answer is not known beforehand only, each cut exact:
//   * FAST: a compass test first. Where fewer than two of the ring points
//     0, 4, 8, 12 clear the threshold in both polarities, no arc of 9 can
//     (every such arc holds two of them, and x - t > 0 exactly when
//     x > t), so the score is exactly 0. The candidates that pass (a
//     minority of the pixels, more on the smaller levels) are compacted
//     into a list, so that the full score runs on dense warps.
//   * The full score with less arithmetic, exact because min, max and
//     negation round nothing: the 16 circular arc minima of length 9 by
//     doubling (windows of 2, 4, 8, then 9: 64 operations instead of 128
//     per polarity), and the dark score as -(min over arcs of the arc
//     maxima) instead of negating every difference.
//   * NMS only where the score is positive; Harris only at the NMS
//     survivors (1.7-3.6 % of the pixels on the 752x480 pyramid of
//     chip_smoke.py), which are the only pixels whose
//     output is not -3e38. Eight lanes share a corner: lane j forms the
//     Sobel products of window column j and their vertical sums, and
//     shuffles gather the columns for the horizontal sum.
// - Built with --fmad=false; the Sobel products, the box sums (rows top
//   first, then centre, -d, +d) and Harris keep the plain version's
//   operation order, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TW = 32, TH = 32;        // output tile
constexpr int NT = 256;                // threads a block
constexpr int MAX_R = 4;               // largest box radius (harris_block <= 9)
constexpr int HALO = MAX_R + 1;        // Sobel + box; covers FAST's ring 3 + NMS 1
constexpr int SW = TW + 2 * HALO, SH = TH + 2 * HALO;
constexpr int NW = TW + 2, NH = TH + 2;  // FAST scores: the tile and its NMS ring
constexpr float NEG_INF = -3.0e38f;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py FAST_RING)
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

}  // namespace

// The level table, passed by value (mirrored by ops/cuda/_lib.py
// CornerLevels). first_tile is filled by the entry point.
struct CornerLevels {
  const float* img[MAX_LEVELS];
  float* out[MAX_LEVELS];
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  int first_tile[MAX_LEVELS + 1];  // prefix sums of tiles per level, per frame
  int num_levels;
};

namespace {

// false where fewer than two of the compass points 0, 4, 8, 12 clear the
// threshold in either polarity: then no arc of 9 can, and the score is 0
__device__ __forceinline__ bool fast_candidate(const float (*img)[SW], int sy, int sx,
                                               float t) {
  const float c = img[sy][sx];
  const float n0 = img[sy - 3][sx] - c, n4 = img[sy][sx + 3] - c;
  const float n8 = img[sy + 3][sx] - c, n12 = img[sy][sx - 3] - c;
  const int bright_hits = (n0 > t) + (n4 > t) + (n8 > t) + (n12 > t);
  const int dark_hits = (n0 < -t) + (n4 < -t) + (n8 < -t) + (n12 < -t);
  return bright_hits >= 2 || dark_hits >= 2;
}

__device__ __forceinline__ float fast_score(const float (*img)[SW], int sy, int sx, float t) {
  const float c = img[sy][sx];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = img[sy + RING_DY[i]][sx + RING_DX[i]] - c;
  // circular window minima / maxima: lo[i] = min d[i .. i+w-1], w = 2, 4, 8
  float lo[16], hi[16], lo2[16], hi2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo[i] = fminf(d[i], d[(i + 1) & 15]);
    hi[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(lo[i], lo[(i + 2) & 15]);
    hi2[i] = fmaxf(hi[i], hi[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo[i] = fminf(lo2[i], lo2[(i + 4) & 15]);
    hi[i] = fmaxf(hi2[i], hi2[(i + 4) & 15]);
  }
  // windows of 9; bright = max of the arc minima, dark = -(min of the arc maxima)
  float bright = fminf(lo[0], d[8]), dark_neg = fmaxf(hi[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    bright = fmaxf(bright, fminf(lo[i], d[(i + 8) & 15]));
    dark_neg = fminf(dark_neg, fmaxf(hi[i], d[(i + 8) & 15]));
  }
  return fmaxf(fmaxf(bright, -dark_neg) - t, 0.0f);
}

// warp-aggregated append of `value` where `pred` holds; every lane calls it
__device__ __forceinline__ void append(short* list, int* count, bool pred, int value,
                                       int lane) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (!m) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
  if (pred) list[base + __popc(m & ((1u << lane) - 1u))] = (short)value;
}

template <int R>
__global__ void __launch_bounds__(NT)
corner_rank_maps_kernel(const CornerLevels L, float threshold, float harris_k) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[NH][NW];
  __shared__ short s_cand[NH * NW];    // FAST candidates (score-grid index)
  __shared__ short s_pos[TH * TW];     // positive scores in the tile (tile index)
  __shared__ short s_corner[TH * TW];  // NMS survivors (tile index)
  __shared__ unsigned char s_flag[TH * TW];
  __shared__ int s_n[3];

  // (frame, level, tile) from the flat block index
  const int tiles = L.first_tile[L.num_levels];
  const int frame = blockIdx.x / tiles;
  const int t = blockIdx.x - frame * tiles;
  int lvl = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) lvl += (i < L.num_levels && t >= L.first_tile[i]);
  const int H = L.height[lvl], W = L.width[lvl];
  const int tile = t - L.first_tile[lvl];
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const float* src = L.img[lvl] + (size_t)frame * H * W;
  float* dst = L.out[lvl] + (size_t)frame * H * W;
  const int tid = threadIdx.x, lane = tid % 32;

  // 1. tile + halo of the edge-clamped image
  if (tid < 3) s_n[tid] = 0;
  for (int i = tid; i < TH * TW; i += NT) s_flag[i] = 0;
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i % SW;
    const int gy = min(max(y0 + ly - HALO, 0), H - 1);
    const int gx = min(max(x0 + lx - HALO, 0), W - 1);
    s_img[ly][lx] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. compass test on the tile and its 1-px NMS ring; the rest score 0
  for (int base = 0; base < NH * NW; base += NT) {
    const int i = base + tid;
    bool cand = false;
    if (i < NH * NW) {
      const int ly = i / NW, lx = i % NW;
      cand = fast_candidate(s_img, HALO - 1 + ly, HALO - 1 + lx, threshold);
      if (!cand) s_score[ly][lx] = 0.0f;
    }
    append(s_cand, &s_n[0], cand, i, lane);
  }
  __syncthreads();

  // 3. full FAST score of the candidates; positives inside the tile and
  //    the level are the NMS's work list
  const int n_cand = s_n[0];
  for (int base = 0; base < n_cand; base += NT) {
    const int j = base + tid;
    bool pos = false;
    int idx = 0;
    if (j < n_cand) {
      const int i = s_cand[j], ly = i / NW, lx = i % NW;
      const float sc = fast_score(s_img, HALO - 1 + ly, HALO - 1 + lx, threshold);
      s_score[ly][lx] = sc;
      const int oy = ly - 1, ox = lx - 1;
      pos = sc > 0.0f && oy >= 0 && oy < TH && ox >= 0 && ox < TW && y0 + oy < H &&
            x0 + ox < W;
      idx = oy * TW + ox;
    }
    append(s_pos, &s_n[1], pos, idx, lane);
  }
  __syncthreads();

  // 4. NMS: keep a positive score that equals its 3x3 maximum
  const int n_pos = s_n[1];
  for (int base = 0; base < n_pos; base += NT) {
    const int j = base + tid;
    bool keep = false;
    int idx = 0;
    if (j < n_pos) {
      idx = s_pos[j];
      const int oy = idx / TW, ox = idx % TW;
      const float sc = s_score[oy + 1][ox + 1];
      float pooled = sc;
#pragma unroll
      for (int dy = 0; dy <= 2; ++dy)
#pragma unroll
        for (int dx = 0; dx <= 2; ++dx) pooled = fmaxf(pooled, s_score[oy + dy][ox + dx]);
      keep = sc >= pooled;
      if (keep) s_flag[idx] = 1;
    }
    append(s_corner, &s_n[2], keep, idx, lane);
  }
  __syncthreads();

  // 5. -3e38 wherever no corner sits
  for (int i = tid; i < TH * TW; i += NT) {
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    if (gy < H && gx < W && !s_flag[i]) dst[(size_t)gy * W + gx] = NEG_INF;
  }

  // 6. Harris at the corners, 8 lanes a corner: lane j builds the Sobel
  //    products of window column j (and j + 8) and their vertical sums,
  //    top row first; shuffles gather the columns for the horizontal sum
  //    (centre, then -d and +d), as the plain version orders them
  constexpr int COLS = 2 * R + 1, NC = (COLS + 7) / 8;
  const int n_corner = s_n[2];
  const int j = lane % 8;
  for (int base = (tid / 32) * 4; base < n_corner; base += NT / 8) {
    const int c = base + lane / 8;
    const int idx = c < n_corner ? s_corner[c] : 0;
    const int oy = idx / TW, ox = idx % TW;
    float v[3][NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int x = HALO + ox - R + min(j + 8 * cc, COLS - 1);
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int y = HALO + oy - R + k;
        const float gx = s_img[y - 1][x + 1] - s_img[y - 1][x - 1]
                         + 2.0f * (s_img[y][x + 1] - s_img[y][x - 1])
                         + s_img[y + 1][x + 1] - s_img[y + 1][x - 1];
        const float gy = s_img[y + 1][x - 1] - s_img[y - 1][x - 1]
                         + 2.0f * (s_img[y + 1][x] - s_img[y - 1][x])
                         + s_img[y + 1][x + 1] - s_img[y - 1][x + 1];
        const float p[3] = {gx * gx, gy * gy, gx * gy};
#pragma unroll
        for (int q = 0; q < 3; ++q) v[q][cc] = k ? v[q][cc] + p[q] : p[q];
      }
    }
    float s[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float a = __shfl_sync(0xFFFFFFFFu, v[q][R / 8], R % 8, 8);
#pragma unroll
      for (int d = 1; d <= R; ++d) {
        a = a + __shfl_sync(0xFFFFFFFFu, v[q][(R - d) / 8], (R - d) % 8, 8);
        a = a + __shfl_sync(0xFFFFFFFFu, v[q][(R + d) / 8], (R + d) % 8, 8);
      }
      s[q] = a;
    }
    if (j == 0 && c < n_corner) {
      const float det = s[0] * s[1] - s[2] * s[2];
      const float tr = s[0] + s[1];
      dst[(size_t)(y0 + oy) * W + x0 + ox] = det - harris_k * tr * tr;
    }
  }
}

}  // namespace

extern "C" int corner_rank_maps_launch(CornerLevels levels, int B, float threshold,
                                       float harris_k, int box_r, void* stream) {
  if (box_r < 1 || box_r > MAX_R || B < 1 || levels.num_levels < 1 ||
      levels.num_levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  for (int l = 0; l < levels.num_levels; ++l) {
    const int h = levels.height[l], w = levels.width[l];
    if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    levels.first_tile[l] = (int)tiles;
    tiles += (long long)((h + TH - 1) / TH) * ((w + TW - 1) / TW);
    if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  levels.first_tile[levels.num_levels] = (int)tiles;
  if (tiles * B > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles * B);
  cudaStream_t s = (cudaStream_t)stream;
  switch (box_r) {
    case 1: corner_rank_maps_kernel<1><<<grid, NT, 0, s>>>(levels, threshold, harris_k); break;
    case 2: corner_rank_maps_kernel<2><<<grid, NT, 0, s>>>(levels, threshold, harris_k); break;
    case 3: corner_rank_maps_kernel<3><<<grid, NT, 0, s>>>(levels, threshold, harris_k); break;
    default: corner_rank_maps_kernel<4><<<grid, NT, 0, s>>>(levels, threshold, harris_k); break;
  }
  return (int)cudaGetLastError();
}
