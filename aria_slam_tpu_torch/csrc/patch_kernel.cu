// Per-keypoint square patch extraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel aria_slam_tpu/ops/pallas/patch_kernel.py
// (_patch_kernel, reached through extract_patches). Same function: from a
// (B, H, W) float32 image and (B, K, 2) keypoint centres, the (B, K, S, S)
// patches, S = 2 radius + 1, whose top-left corner is
// clip(round(xy) - radius, 0, W-1 / H-1); reads past the right or bottom
// edge repeat the last column or row. The TPU cut patches with one-hot
// selection matmuls because arbitrary gathers are slow there; on this
// card it is a plain gather.
//
// What bounds it on this card: bytes. It moves K * S * S * 4 bytes of
// output (12.2 MB a frame at 2000 keypoints, S = 39) and does no
// arithmetic beyond the addresses.
//
// Design: one block per (batch, group of G keypoints). The block reads
// its keypoints' corners once into shared memory; then consecutive
// threads write consecutive output floats (coalesced stores), each
// reading one clamped source pixel, which the patches' overlap keeps in
// L1/L2. No padding of the image and no 40x40 staging.

#include <cuda_runtime.h>

namespace {

constexpr int G = 8;          // keypoints per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
extract_patches_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                       float* __restrict__ out, int H, int W, int K, int radius) {
  __shared__ int s_x0[G], s_y0[G];
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * G;
  const int ng = min(G, K - k0);
  const int size = 2 * radius + 1, area = size * size;
  if (threadIdx.x < ng) {
    const float* p = xy + ((size_t)b * K + k0 + threadIdx.x) * 2;
    const int x0 = (int)rintf(p[0]) - radius;  // round half to even
    const int y0 = (int)rintf(p[1]) - radius;
    s_x0[threadIdx.x] = min(max(x0, 0), W - 1);
    s_y0[threadIdx.x] = min(max(y0, 0), H - 1);
  }
  __syncthreads();
  const float* src = img + (size_t)b * H * W;
  float* dst = out + ((size_t)b * K + k0) * area;
  for (int i = threadIdx.x; i < ng * area; i += THREADS) {
    const int g = i / area, rem = i - g * area;
    const int py = rem / size, px = rem - py * size;
    const int y = min(s_y0[g] + py, H - 1), x = min(s_x0[g] + px, W - 1);
    dst[i] = src[(size_t)y * W + x];
  }
}

}  // namespace

extern "C" int extract_patches_launch(const void* img, const void* xy, void* out,
                                      int B, int H, int W, int K, int radius,
                                      void* stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || radius < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((K + G - 1) / G, B);
  extract_patches_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)xy, (float*)out, H, W, K, radius);
  return (int)cudaGetLastError();
}
