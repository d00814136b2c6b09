// Transmittance compositing, forward (K1) and backward (K2), for sm_90a.
//
// Replaces the Pallas TPU kernels of nmf_tpu/ops/pallas/composite.py:
// _fwd_kernel (forward scan) and _bwd_kernel (recompute + reverse scan),
// behind composite_rays and transmittance_weights.
//
// Per ray, over its K samples:
//   alpha_k = 1 - exp(-sigma_k * dist_k),  f_k = (1 - alpha_k) + 1e-10,
//   w_k = alpha_k * T_k,  T_{k+1} = T_k * f_k,  T_0 = 1,
// plus, when asked for, rgb_map = sum w_k rgb_k, acc = sum w_k and
// depth = sum w_k z_k.
//
// What bounds it on the H100: bytes. The forward reads two (B, K) f32 arrays
// and writes one; the backward reads three and writes one (weights-only).
// At the train step's B = 4096, K = 192 that is about 3 MB an array: 2.8 us
// forward and 3.8 us backward at 3.35 TB/s, which is close to the card's
// launch-to-launch floor, so half of the byte bound may not be reachable at
// that shape. What held the one-thread-per-ray design back was latency: 32
// blocks on 132 SMs, 192 dependent steps per thread, and 32 rows 768 bytes
// apart on every load and store.
//
// Design: one warp per ray, kWarps rays per block (B = 4096 gives 4096
// warps, ~31 an SM; the retrace pass's B = 1024 ~8). The warp walks its ray
// in tiles of kTile = 192 samples, kV = 6 consecutive samples per lane.
// Loads and stores are coalesced: sample j * 32 + lane of the tile
// ("coalesced" order) is read and written by one instruction across the
// warp, and a per-warp shared-memory transpose (skewed by one word every
// 32, so free of bank conflicts) moves values to the lane that owns sample
// lane * kV + j ("lane" order) for the scans. Samples past K are masked
// (alpha 0, f 1), so any K works; a ray shorter than a tile (the flagship's
// K = 96) leaves the upper lanes' samples masked.
//
// Forward: each lane multiplies its kV factors f_k in order; a warp
// exclusive product scan (Hillis-Steele, 5 __shfl_up_sync steps) gives the
// T at the lane's first sample, times the tile's starting T; a sequential
// pass over the lane's kV samples gives each T_k and w_k. The tile's product
// carries T to the next tile. Only the order of the products differs from
// the plain cumprod: the factors stay as raw2alpha rounds them, in linear
// space (a log-space sum would round otherwise and lose opaque rays).
//
// Backward: s_k = g_w_k + g_rgb . rgb_k + g_acc + g_depth * z_k is the total
// cotangent of w_k. With R_k = sum_{j>k} s_j alpha_j prod_{k<i<j} f_i,
//   dL/dalpha_k = T_k * (s_k - R_k),   R_{k-1} = f_k R_k + s_k alpha_k.
// This equals the Pallas form T_k s_k - (sum_{j>k} w_j s_j) / f_k but
// divides by nothing: the Pallas backward rebuilds T_k by dividing T_{k+1}
// by f_k, which loses T on opaque rays once it underflows. T_k is
// recomputed with the forward's scan. The R recurrence composes affine maps
// R -> a R + b, so each lane folds its kV samples into one map (a = the
// lane's product of f, b from its samples), a warp suffix scan of the maps
// (5 __shfl_down_sync steps) gives the R entering each lane from the right,
// and R carries from the last tile back to the first. A ray of one tile
// (K <= 192) is read once and held in registers; a longer ray first runs
// the forward scan over its tiles and keeps each tile's starting T in
// shared memory. No division anywhere, f32 throughout.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr int kV = 6;      // samples per lane per tile
constexpr int kTile = 32 * kV;
constexpr int kBufferWords = kTile + kV;  // a tile and its skew
constexpr unsigned kFull = 0xffffffffu;

// Word of sample p of a tile in the per-warp transpose buffer: one word of
// skew every 32 keeps both orders free of bank conflicts.
__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }

// coalesced order (sample j * 32 + lane) -> lane order (sample lane * kV + j)
__device__ __forceinline__ void to_lane_order(float* buf,
                                              const float (&c)[kV],
                                              float (&l)[kV], int lane) {
#pragma unroll
  for (int j = 0; j < kV; ++j) buf[skew(j * 32 + lane)] = c[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kV; ++j) l[j] = buf[skew(lane * kV + j)];
  __syncwarp();
}

// lane order -> coalesced order
__device__ __forceinline__ void to_coalesced(float* buf,
                                             const float (&l)[kV],
                                             float (&c)[kV], int lane) {
#pragma unroll
  for (int j = 0; j < kV; ++j) buf[skew(lane * kV + j)] = l[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kV; ++j) c[j] = buf[skew(j * 32 + lane)];
  __syncwarp();
}

// alpha of the tile's samples in coalesced order (0 past K), and
// e = exp(-sigma * dist) (1 past K).
__device__ __forceinline__ void load_alpha(const float* sigma,
                                           const float* dist, long long row,
                                           int k0, int K, int lane,
                                           float (&alpha)[kV],
                                           float (&e)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int k = k0 + j * 32 + lane;
    e[j] = k < K ? expf(-sigma[row + k] * dist[row + k]) : 1.f;
    alpha[j] = 1.f - e[j];
  }
}

// Transmittance of the lane's kV samples (lane order) from the tile's
// starting T0. f are the lane's factors; returns the lane's product of f in
// `lane_prod` and the tile's product.
__device__ __forceinline__ float scan_transmittance(const float (&f)[kV],
                                                    float T0, float (&T)[kV],
                                                    float& lane_prod,
                                                    int lane) {
  float p = f[0];
#pragma unroll
  for (int j = 1; j < kV; ++j) p = p * f[j];
  lane_prod = p;
  float x = p;  // inclusive product over lanes 0..lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = y * x;
  }
  float t = __shfl_up_sync(kFull, x, 1);
  t = T0 * (lane == 0 ? 1.f : t);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    T[j] = t;
    t = t * f[j];
  }
  return __shfl_sync(kFull, x, 31);
}

__global__ void __launch_bounds__(kWarps * 32) composite_fwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ dist,
    const float* __restrict__ rgb, const float* __restrict__ z,
    float* __restrict__ weights, float* __restrict__ rgb_map,
    float* __restrict__ acc, float* __restrict__ depth, int B, int K) {
  __shared__ float smem[kWarps * kBufferWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp: one ray per warp
  float* buf = smem + warp * kBufferWords;
  const long long row = static_cast<long long>(b) * K;

  float T0 = 1.f, r = 0.f, g = 0.f, bl = 0.f, a = 0.f, d = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    float alpha_c[kV], e[kV], alpha[kV], f[kV], T[kV], w[kV], w_c[kV];
    float lane_prod;
    load_alpha(sigma, dist, row, k0, K, lane, alpha_c, e);
    to_lane_order(buf, alpha_c, alpha, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) f[j] = (1.f - alpha[j]) + 1e-10f;
    const float tile_prod = scan_transmittance(f, T0, T, lane_prod, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) w[j] = alpha[j] * T[j];
    to_coalesced(buf, w, w_c, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j * 32 + lane;
      if (k >= K) continue;
      const long long i = row + k;
      weights[i] = w_c[j];
      a += w_c[j];
      if (rgb != nullptr) {
        r += w_c[j] * rgb[3 * i];
        g += w_c[j] * rgb[3 * i + 1];
        bl += w_c[j] * rgb[3 * i + 2];
      }
      if (z != nullptr) d += w_c[j] * z[i];
    }
    T0 = T0 * tile_prod;
  }
  if (rgb_map == nullptr && acc == nullptr && depth == nullptr) return;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    r += __shfl_xor_sync(kFull, r, m);
    g += __shfl_xor_sync(kFull, g, m);
    bl += __shfl_xor_sync(kFull, bl, m);
    a += __shfl_xor_sync(kFull, a, m);
    d += __shfl_xor_sync(kFull, d, m);
  }
  if (lane != 0) return;
  if (rgb_map != nullptr) {
    rgb_map[3 * b] = r;
    rgb_map[3 * b + 1] = g;
    rgb_map[3 * b + 2] = bl;
  }
  if (acc != nullptr) acc[b] = a;
  if (depth != nullptr) depth[b] = d;
}

// Dynamic shared memory per warp: the transpose buffer, then the starting
// T of each of the ray's n_tiles tiles.
__global__ void __launch_bounds__(kWarps * 32) composite_bwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ dist,
    const float* __restrict__ rgb, const float* __restrict__ z,
    const float* __restrict__ g_w, const float* __restrict__ g_rgb,
    const float* __restrict__ g_acc, const float* __restrict__ g_depth,
    float* __restrict__ d_sigma, float* __restrict__ d_dist,
    float* __restrict__ d_rgb, float* __restrict__ d_z, int B, int K,
    int n_tiles) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  float* buf = smem + warp * (kBufferWords + n_tiles);
  float* tile_T = buf + kBufferWords;
  const long long row = static_cast<long long>(b) * K;

  // rays longer than one tile: the forward scan, keeping each tile's T0
  float T0 = 1.f;
  if (lane == 0) tile_T[0] = 1.f;
  for (int t = 0; t + 1 < n_tiles; ++t) {
    float alpha_c[kV], e[kV], alpha[kV], f[kV], T[kV], lane_prod;
    load_alpha(sigma, dist, row, t * kTile, K, lane, alpha_c, e);
    to_lane_order(buf, alpha_c, alpha, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) f[j] = (1.f - alpha[j]) + 1e-10f;
    T0 = T0 * scan_transmittance(f, T0, T, lane_prod, lane);
    if (lane == 0) tile_T[t + 1] = T0;
  }
  __syncwarp();

  const float gr = g_rgb != nullptr ? g_rgb[3 * b] : 0.f;
  const float gg = g_rgb != nullptr ? g_rgb[3 * b + 1] : 0.f;
  const float gb = g_rgb != nullptr ? g_rgb[3 * b + 2] : 0.f;
  const float ga = g_acc != nullptr ? g_acc[b] : 0.f;
  const float gd = g_depth != nullptr ? g_depth[b] : 0.f;

  float R = 0.f;  // R at the last sample of the tile (0 past the ray)
  for (int t = n_tiles - 1; t >= 0; --t) {
    const int k0 = t * kTile;
    float alpha_c[kV], e[kV], s_c[kV], alpha[kV], s[kV], f[kV], T[kV];
    float lane_prod;
    load_alpha(sigma, dist, row, k0, K, lane, alpha_c, e);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j * 32 + lane;
      s_c[j] = 0.f;
      if (k >= K) continue;
      const long long i = row + k;
      float sk = ga;
      if (g_w != nullptr) sk += g_w[i];
      if (rgb != nullptr)
        sk += gr * rgb[3 * i] + gg * rgb[3 * i + 1] + gb * rgb[3 * i + 2];
      if (z != nullptr) sk += gd * z[i];
      s_c[j] = sk;
    }
    to_lane_order(buf, alpha_c, alpha, lane);
    to_lane_order(buf, s_c, s, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) f[j] = (1.f - alpha[j]) + 1e-10f;
    scan_transmittance(f, tile_T[t], T, lane_prod, lane);

    // the lane's map R -> a R + b over its samples, last to first
    float ma = lane_prod, mb = 0.f;
#pragma unroll
    for (int j = kV - 1; j >= 0; --j) mb = f[j] * mb + s[j] * alpha[j];
    // suffix scan: the lane's map after the maps of lanes lane+1..31
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float na = __shfl_down_sync(kFull, ma, d);
      const float nb = __shfl_down_sync(kFull, mb, d);
      if (lane + d < 32) {
        mb = ma * nb + mb;
        ma = ma * na;
      }
    }
    const float ea = __shfl_down_sync(kFull, ma, 1);
    const float eb = __shfl_down_sync(kFull, mb, 1);
    float Rk = lane == 31 ? R : ea * R + eb;  // R at the lane's last sample
    float d_alpha[kV], d_alpha_c[kV];
#pragma unroll
    for (int j = kV - 1; j >= 0; --j) {
      d_alpha[j] = T[j] * (s[j] - Rk);
      Rk = f[j] * Rk + s[j] * alpha[j];
    }
    R = __shfl_sync(kFull, Rk, 0);

    to_coalesced(buf, d_alpha, d_alpha_c, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j * 32 + lane;
      if (k >= K) continue;
      const long long i = row + k;
      d_sigma[i] = d_alpha_c[j] * dist[i] * e[j];
      if (d_dist != nullptr) d_dist[i] = d_alpha_c[j] * sigma[i] * e[j];
    }
    if (d_rgb == nullptr && d_z == nullptr) continue;
    float w[kV], w_c[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) w[j] = alpha[j] * T[j];
    to_coalesced(buf, w, w_c, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int k = k0 + j * 32 + lane;
      if (k >= K) continue;
      const long long i = row + k;
      if (d_rgb != nullptr) {
        d_rgb[3 * i] = w_c[j] * gr;
        d_rgb[3 * i + 1] = w_c[j] * gg;
        d_rgb[3 * i + 2] = w_c[j] * gb;
      }
      if (d_z != nullptr) d_z[i] = w_c[j] * gd;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is device memory
// that the caller allocated; a null rgb / z / output pointer skips that
// input or output. They launch on `stream` and return cudaGetLastError().
extern "C" int composite_fwd(const float* sigma, const float* dist,
                             const float* rgb, const float* z, float* weights,
                             float* rgb_map, float* acc, float* depth, int B,
                             int K, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  composite_fwd_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      sigma, dist, rgb, z, weights, rgb_map, acc, depth, B, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_bwd(const float* sigma, const float* dist,
                             const float* rgb, const float* z,
                             const float* g_w, const float* g_rgb,
                             const float* g_acc, const float* g_depth,
                             float* d_sigma, float* d_dist, float* d_rgb,
                             float* d_z, int B, int K, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  const int n_tiles = (K + kTile - 1) / kTile;
  // within the default 48 KB for rays of up to ~550,000 samples; past that
  // the launch fails and its error is returned
  const size_t smem = sizeof(float) * kWarps * (kBufferWords + n_tiles);
  composite_bwd_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      sigma, dist, rgb, z, g_w, g_rgb, g_acc, g_depth, d_sigma, d_dist, d_rgb,
      d_z, B, K, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel's launch: timed back to back, it gives the launch floor
// that the kernels' times are read against.
extern "C" int composite_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
