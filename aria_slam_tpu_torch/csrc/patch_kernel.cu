// Per-keypoint square patch extraction for Hopper (sm_90a), every pyramid
// level of every frame in one launch.
//
// Replaces the Pallas kernel aria_slam_tpu/ops/pallas/patch_kernel.py
// (_patch_kernel, reached through extract_patches). Same function, per
// level: from a (B, H, W) float32 image and (B, K, 2) keypoint centres, the
// (B, K, S, S) patches, S = 2 radius + 1, whose top-left corner is
// clip(round_half_even(xy) - radius, 0, W-1 / H-1); reads past the right or
// bottom edge repeat the last column or row. The levels' patches are
// concatenated along the keypoint axis: the output is (B, sum K, S, S).
// The TPU cut patches with one-hot selection matmuls because arbitrary
// gathers are slow there; on this card it is a gather.
//
// What bounds it on this card: bytes. It writes K S^2 4 bytes (12.2 MB a
// frame at 2000 keypoints, S = 39), reads at most the pixels the patches
// cover and does no arithmetic beyond the addresses. One launch a level
// left most of the card idle: 55 blocks or fewer a launch, 8 launches.
//
// Design:
// - One launch for all levels and frames: the grid flattens (frame, level,
//   group of G keypoints). The level table arrives by value; a block finds
//   its level from the prefix sums of blocks per level, so the small levels
//   run beside level 0: 1003 blocks at B = 1 with the default 2000-keypoint
//   quotas, for 132 SMs. Two keypoints and 128 threads a block: the
//   fastest of the shapes tried on the card (1 to 8 keypoints, 32 to 256
//   threads).
// - A group's G patches are one contiguous range of the output. The block
//   stages that range in shared memory in output order, one 4-byte
//   cp.async a pixel straight from the image (no registers; every copy of
//   a thread in flight at once). The corner clamp and the edge repetition
//   are two mins on the source row and column, so there is no separate
//   edge path and every centre takes the same code.
// - The staged range sits in shared memory at the same offset modulo 16
//   bytes as in the output, so the store is a copy of aligned float4s:
//   16-byte stores to consecutive addresses, with at most 3 scalar floats
//   before and after. A group's output offset, (frame sum K + key) S^2
//   floats, is odd for odd keys, hence the head.
// - The pixel a thread stages advances by fixed carries in (patch, row,
//   column) counters: no division in any loop.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int G = 2;        // keypoints a block
constexpr int NT = 128;     // threads a block
constexpr int MAX_R = 19;   // S <= 39, the TPU kernel's largest patch
constexpr int MAX_AREA = (2 * MAX_R + 1) * (2 * MAX_R + 1);

}  // namespace

// The level table, passed by value (mirrored by ops/cuda/_lib.py
// PatchLevels; ops/cuda/patch_kernel.py level_plan fills the prefix sums).
struct PatchLevels {
  const float* img[MAX_LEVELS];
  const float* xy[MAX_LEVELS];
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  int keys[MAX_LEVELS];
  int first_key[MAX_LEVELS + 1];    // the level's first keypoint in a frame's output
  int first_block[MAX_LEVELS + 1];  // the level's first block of a frame's share of the grid
  int num_levels;
};

namespace {

// 4 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__global__ void __launch_bounds__(NT)
extract_patches_kernel(const PatchLevels L, float* __restrict__ out, int radius) {
  __shared__ __align__(16) float s_patch[G * MAX_AREA + 4];
  __shared__ int s_x0[G], s_y0[G];

  // (frame, level, group) from the flat block index
  const int blocks = L.first_block[L.num_levels];
  const int frame = blockIdx.x / blocks;
  const int t = blockIdx.x - frame * blocks;
  int lvl = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) lvl += (i < L.num_levels && t >= L.first_block[i]);
  const int H = L.height[lvl], W = L.width[lvl], K = L.keys[lvl];
  const int k0 = (t - L.first_block[lvl]) * G;
  const int n = min(G, K - k0);
  const int size = 2 * radius + 1, area = size * size, total = n * area;
  const int tid = threadIdx.x;

  if (tid < n) {
    const float* p = L.xy[lvl] + ((size_t)frame * K + k0 + tid) * 2;
    s_x0[tid] = min(max((int)rintf(p[0]) - radius, 0), W - 1);  // round half to even
    s_y0[tid] = min(max((int)rintf(p[1]) - radius, 0), H - 1);
  }
  __syncthreads();

  // the group's output range is out[start, start + total); s_patch[lead + e]
  // holds out[start + e], lead = start mod 4
  const size_t start =
      ((size_t)frame * L.first_key[L.num_levels] + L.first_key[lvl] + k0) * area;
  const int lead = (int)(start & 3);
  const float* src = L.img[lvl] + (size_t)frame * H * W;

  // 1. stage: element e = tid + NT i as (patch, row, column) counters that
  //    advance by NT in the mixed radix (area, size)
  {
    int p = tid / area, py = tid % area / size, px = tid % size;
    const int sp = NT / area, spy = NT % area / size, spx = NT % size;
    for (int e = tid; e < total; e += NT) {
      const int y = min(s_y0[p] + py, H - 1), x = min(s_x0[p] + px, W - 1);
      cp_async4(&s_patch[lead + e], src + (size_t)y * W + x);
      px += spx;
      const int cx = px >= size;
      px -= cx * size;
      py += spy + cx;
      const int cy = py >= size;
      py -= cy * size;
      p += sp + cy;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // 2. store: scalars up to the output's first 16-byte boundary, aligned
  //    float4s, scalars after the last
  float* dst = out + start;
  const int head = min((4 - lead) & 3, total);
  const int body = (total - head) / 4;
  const int tail = head + 4 * body;
  if (tid < head) dst[tid] = s_patch[lead + tid];
  const float4* s4 = reinterpret_cast<const float4*>(s_patch + lead + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int q = tid; q < body; q += NT) d4[q] = s4[q];
  if (tid < total - tail) dst[tail + tid] = s_patch[lead + tail + tid];
}

}  // namespace

// out: (B, first_key[num_levels], S, S) float32, 16-byte aligned
extern "C" int extract_patches_launch(PatchLevels levels, void* out, int B, int radius,
                                      void* stream) {
  const int nl = levels.num_levels;
  if (B < 1 || radius < 0 || radius > MAX_R || nl < 1 || nl > MAX_LEVELS ||
      levels.first_key[0] != 0 || levels.first_block[0] != 0 || (size_t)out % 16)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nl; ++l) {
    const int k = levels.keys[l];
    if (levels.height[l] < 1 || levels.width[l] < 1 || k < 0 ||
        levels.first_key[l + 1] != levels.first_key[l] + k ||
        levels.first_block[l + 1] != levels.first_block[l] + (k + G - 1) / G)
      return (int)cudaErrorInvalidValue;
  }
  const long long grid = (long long)levels.first_block[nl] * B;
  if (grid < 1 || grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  extract_patches_kernel<<<(unsigned)grid, NT, 0, (cudaStream_t)stream>>>(
      levels, (float*)out, radius);
  return (int)cudaGetLastError();
}
