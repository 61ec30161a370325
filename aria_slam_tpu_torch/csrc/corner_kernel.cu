// FAST-9 + 3x3 NMS + Harris corner rank map for Hopper (sm_90a).
//
// Replaces the Pallas kernel aria_slam_tpu/ops/pallas/corner_kernel.py
// (_corner_rank_kernel, reached through corner_rank_map_batched). Same
// function: for every pixel of a (B, H, W) float32 image, computed on the
// image edge-replicated in every direction, the Harris response
// (3x3 Sobel, box sum of the gradient products, det - k tr^2) where an
// NMS-surviving FAST-9 corner sits (16-px ring, 9-long arc, margin over
// the threshold), and -3e38 elsewhere.
//
// What bounds it on this card: operations. Each output pixel costs
// about 400 float32 operations (16 ring differences, 2 x 16 arcs of 8
// minima, the arc maxima, 9 NMS maxima, Sobel, the 7x7 box sums of three
// products, the Harris combination) against 8 bytes of device traffic
// (one read, one write), far above the card's 20 float operations per
// byte of bandwidth.
//
// Design: one thread per output pixel of a 32x16 tile. The block stages
// the tile plus a +-8 halo of the edge-clamped image in shared memory
// once, computes the FAST score of the tile and a one-pixel ring around
// it (what NMS needs) into shared memory, the gradient products of the
// tile plus the box radius, then the vertical and horizontal box sums,
// all from shared memory. The device sees one read of each input pixel
// (plus the halo) and one float32 store per output pixel. Batched over B
// through blockIdx.z. Built with --fmad=false and written with the same
// operation order as corner_rank_map_plain, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;          // tile width (threads in x)
constexpr int TH = 16;          // tile height (threads in y)
constexpr int HALO = 8;         // staged halo on every side
constexpr int MAX_R = 4;        // largest box radius (harris_block <= 9)
constexpr int SW = TW + 2 * HALO, SH = TH + 2 * HALO;
constexpr int NW = TW + 2, NH = TH + 2;                  // FAST scores for NMS
constexpr int EW = TW + 2 * MAX_R, EH = TH + 2 * MAX_R;  // gradient products
constexpr float NEG_INF = -3.0e38f;
constexpr int ARC_LEN = 9;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py FAST_RING)
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ float fast_score(const float (*img)[SW], int sy, int sx, float threshold) {
  const float c = img[sy][sx];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = img[sy + RING_DY[i]][sx + RING_DX[i]] - c;
  float bright = 0.0f, dark = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mb = d[s], md = -d[s];
#pragma unroll
    for (int i = 1; i < ARC_LEN; ++i) {
      const float x = d[(s + i) & 15];
      mb = fminf(mb, x);
      md = fminf(md, -x);
    }
    bright = s ? fmaxf(bright, mb) : mb;
    dark = s ? fmaxf(dark, md) : md;
  }
  return fmaxf(fmaxf(bright, dark) - threshold, 0.0f);
}

__global__ void __launch_bounds__(TW * TH)
corner_rank_kernel(const float* __restrict__ img, float* __restrict__ out,
                   int H, int W, float threshold, float harris_k, int r) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[NH][NW];
  __shared__ float s_xx[EH][EW], s_yy[EH][EW], s_xy[EH][EW];
  __shared__ float v_xx[TH][EW], v_yy[TH][EW], v_xy[TH][EW];

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const float* src = img + (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * TW + threadIdx.x;
  constexpr int NT = TW * TH;

  // 1. tile + halo of the edge-clamped image
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i % SW;
    const int gy = min(max(y0 + ly - HALO, 0), H - 1);
    const int gx = min(max(x0 + lx - HALO, 0), W - 1);
    s_img[ly][lx] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. FAST score of the tile and a 1-px ring (NMS neighbourhood)
  for (int i = tid; i < NH * NW; i += NT) {
    const int ly = i / NW, lx = i % NW;
    s_score[ly][lx] = fast_score(s_img, HALO - 1 + ly, HALO - 1 + lx, threshold);
  }
  // 3. Sobel gradient products of the tile and an r-px ring
  const int ew = TW + 2 * r, eh = TH + 2 * r;
  for (int i = tid; i < eh * ew; i += NT) {
    const int ly = i / ew, lx = i % ew;
    const int y = HALO - r + ly, x = HALO - r + lx;
    const float gx = s_img[y - 1][x + 1] - s_img[y - 1][x - 1]
                     + 2.0f * (s_img[y][x + 1] - s_img[y][x - 1])
                     + s_img[y + 1][x + 1] - s_img[y + 1][x - 1];
    const float gy = s_img[y + 1][x - 1] - s_img[y - 1][x - 1]
                     + 2.0f * (s_img[y + 1][x] - s_img[y - 1][x])
                     + s_img[y + 1][x + 1] - s_img[y - 1][x + 1];
    s_xx[ly][lx] = gx * gx;
    s_yy[ly][lx] = gy * gy;
    s_xy[ly][lx] = gx * gy;
  }
  __syncthreads();

  // 4. vertical box sums, top row first
  for (int i = tid; i < TH * ew; i += NT) {
    const int ly = i / ew, lx = i % ew;
    float a = s_xx[ly][lx], b = s_yy[ly][lx], c = s_xy[ly][lx];
    for (int k = 1; k <= 2 * r; ++k) {
      a = a + s_xx[ly + k][lx];
      b = b + s_yy[ly + k][lx];
      c = c + s_xy[ly + k][lx];
    }
    v_xx[ly][lx] = a;
    v_yy[ly][lx] = b;
    v_xy[ly][lx] = c;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx >= W || gy >= H) return;

  // 5. NMS: keep a positive score that equals its 3x3 maximum
  const float sc = s_score[ty + 1][tx + 1];
  float pooled = sc;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) pooled = fmaxf(pooled, s_score[ty + 1 + dy][tx + 1 + dx]);
  const bool is_corner = (sc >= pooled) && (sc > 0.0f);

  // 6. horizontal box sums (centre, then -d and +d), Harris
  float sxx = v_xx[ty][tx + r], syy = v_yy[ty][tx + r], sxy = v_xy[ty][tx + r];
  for (int d = 1; d <= r; ++d) {
    sxx = sxx + v_xx[ty][tx + r - d];
    sxx = sxx + v_xx[ty][tx + r + d];
    syy = syy + v_yy[ty][tx + r - d];
    syy = syy + v_yy[ty][tx + r + d];
    sxy = sxy + v_xy[ty][tx + r - d];
    sxy = sxy + v_xy[ty][tx + r + d];
  }
  const float det = sxx * syy - sxy * sxy;
  const float tr = sxx + syy;
  const float harris = det - harris_k * tr * tr;
  out[(size_t)blockIdx.z * H * W + (size_t)gy * W + gx] = is_corner ? harris : NEG_INF;
}

}  // namespace

extern "C" int corner_rank_map_launch(const void* img, void* out, int B, int H, int W,
                                      float threshold, float harris_k, int box_r,
                                      void* stream) {
  if (box_r < 1 || box_r > MAX_R || B < 1 || H < 1 || W < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  corner_rank_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, H, W, threshold, harris_k, box_r);
  return (int)cudaGetLastError();
}
