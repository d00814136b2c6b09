// Row scatter-add ("bin-sum") for sm_90a:
//   out = zeros(R, C); out[idx[n]] += vals[n] for idx[n] in [0, R),
// rows whose id lies outside [0, R) are dropped.
//
// Replaces the Pallas TPU kernel _binsum_kernel of
// nmf_tpu/ops/pallas/binsum.py (behind binsum_rows). The TPU version sorts
// the ids, cuts the sorted rows into 512-row output tiles and accumulates
// each tile with a one-hot matrix product, carrying the ids in a float lane
// (exact below 2^24). None of that is semantics: here the ids stay int32
// and collisions are resolved with atomics.
//
// What bounds it on the H100: bytes. On the train step's plane-gradient
// scatter it reads N = 786,432 rows of C = 160 f32 values (503 MB) and
// writes R x C = 16,384 x 160 f32 (10 MB), about 0.15 ms at 3.35 TB/s; on
// the line-gradient scatter (C = 80, R = 128 or 300 cells, every id hit
// thousands of times) it reads 252 MB, about 0.075 ms.
// Design: consecutive samples of a ray mostly fall into the same texel, so
// neighbouring rows of vals mostly share one id. Each thread owns one
// channel and a contiguous run of rows; it sums while the id repeats and
// flushes one atomicAdd when the id changes or its run ends. A warp covers
// 32 consecutive channels of the same rows, so every row read is one
// coalesced 128-byte load and the id load is a broadcast. The order of the
// atomics varies from run to run, so results match a serial sum to f32
// rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 32;  // threads along C (one warp)
constexpr int kRowGroups = 8;  // threads along N

__global__ void binsum_rows_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, long long N, int C,
                                   int R, int run) {
  const int c = blockIdx.x * kChannels + threadIdx.x;
  const long long start =
      (static_cast<long long>(blockIdx.y) * kRowGroups + threadIdx.y) * run;
  if (c >= C || start >= N) return;
  const long long end = start + run < N ? start + run : N;
  int cur = idx[start];
  float acc = 0.f;
  for (long long n = start; n < end; ++n) {
    const int id = idx[n];
    if (id != cur) {
      if (cur >= 0 && cur < R) atomicAdd(out + static_cast<long long>(cur) * C + c, acc);
      cur = id;
      acc = 0.f;
    }
    acc += vals[n * C + c];
  }
  if (cur >= 0 && cur < R) atomicAdd(out + static_cast<long long>(cur) * C + c, acc);
}

}  // namespace

// Plain C entry point, bound with ctypes. idx (N,) int32, vals (N, C) f32
// and out (R, C) f32 are contiguous device memory; out must be zeroed by
// the caller. Launches on `stream` and returns cudaGetLastError().
extern "C" int binsum_rows(const int* idx, const float* vals, float* out,
                           long long N, int C, int R, cudaStream_t stream) {
  if (N <= 0 || C <= 0 || R <= 0) return 0;
  // rows per thread: 32, or more when N would need more than 65535 blocks
  // along y
  const long long per_block_y = 65535LL * kRowGroups;
  int run = 32;
  if ((N + per_block_y * run - 1) / (per_block_y * run) > 1)
    run = static_cast<int>((N + per_block_y - 1) / per_block_y);
  const dim3 block(kChannels, kRowGroups);
  const dim3 grid((C + kChannels - 1) / kChannels,
                  static_cast<unsigned>((N + static_cast<long long>(kRowGroups) * run - 1) /
                                        (static_cast<long long>(kRowGroups) * run)));
  binsum_rows_kernel<<<grid, block, 0, stream>>>(idx, vals, out, N, C, R, run);
  return static_cast<int>(cudaGetLastError());
}
