// Transmittance compositing, forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernels of nmf_tpu/ops/pallas/composite.py:
// _fwd_kernel (forward scan) and _bwd_kernel (recompute + reverse scan),
// behind composite_rays and transmittance_weights.
//
// Per ray, over its K samples:
//   alpha_k = 1 - exp(-sigma_k * dist_k),  w_k = alpha_k * T_k,
//   T_{k+1} = T_k * (1 - alpha_k + 1e-10),  T_0 = 1,
// plus, when asked for, rgb_map = sum w_k rgb_k, acc = sum w_k and
// depth = sum w_k z_k.
//
// What bounds it on the H100: the forward reads two (B, K) f32 arrays and
// writes one; the backward reads three and writes one to four. At the train
// step's B = 4096, K = 192 that is about 3 MB per array, a few microseconds
// of HBM traffic, so the kernels are bound by launch and per-ray latency.
// Design: one thread per ray, the K loop in registers, no shared memory.
// A thread walks its ray's contiguous row; neighbouring threads' rows share
// cache lines over consecutive k, so the reads are served from L1.
//
// Backward: s_k = g_w_k + g_rgb . rgb_k + g_acc + g_depth * z_k is the total
// cotangent of w_k. With R_k = sum_{j>k} s_j alpha_j prod_{k<i<j}(1-alpha_i+eps)
//   dL/dalpha_k = T_k * (s_k - R_k),   R_{k-1} = s_k alpha_k + (1-alpha_k+eps) R_k.
// This equals the Pallas form T_k s_k - (sum_{j>k} w_j s_j) / (1-alpha_k+eps)
// but divides by nothing: the Pallas backward rebuilds T_k by dividing
// T_{k+1} by (1-alpha_k+eps), which loses T on opaque rays once it
// underflows. Here pass 1 recomputes T_k and stashes it in d_sigma (each
// thread owns its row), and pass 2 reads it back while it runs the reverse
// scan, overwriting the stash with the gradient.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void composite_fwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ dist,
    const float* __restrict__ rgb, const float* __restrict__ z,
    float* __restrict__ weights, float* __restrict__ rgb_map,
    float* __restrict__ acc, float* __restrict__ depth, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long row = static_cast<long long>(b) * K;
  float T = 1.f, r = 0.f, g = 0.f, bl = 0.f, a = 0.f, d = 0.f;
  for (int k = 0; k < K; ++k) {
    const long long i = row + k;
    const float alpha = 1.f - expf(-sigma[i] * dist[i]);
    const float w = alpha * T;
    weights[i] = w;
    if (rgb != nullptr) {
      r += w * rgb[3 * i];
      g += w * rgb[3 * i + 1];
      bl += w * rgb[3 * i + 2];
    }
    a += w;
    if (z != nullptr) d += w * z[i];
    T = T * ((1.f - alpha) + 1e-10f);
  }
  if (rgb_map != nullptr) {
    rgb_map[3 * b] = r;
    rgb_map[3 * b + 1] = g;
    rgb_map[3 * b + 2] = bl;
  }
  if (acc != nullptr) acc[b] = a;
  if (depth != nullptr) depth[b] = d;
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ sigma, const float* __restrict__ dist,
    const float* __restrict__ rgb, const float* __restrict__ z,
    const float* __restrict__ g_w, const float* __restrict__ g_rgb,
    const float* __restrict__ g_acc, const float* __restrict__ g_depth,
    float* __restrict__ d_sigma, float* __restrict__ d_dist,
    float* __restrict__ d_rgb, float* __restrict__ d_z, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long row = static_cast<long long>(b) * K;

  // pass 1: T_k into the d_sigma row
  float T = 1.f;
  for (int k = 0; k < K; ++k) {
    const long long i = row + k;
    const float alpha = 1.f - expf(-sigma[i] * dist[i]);
    d_sigma[i] = T;
    T = T * ((1.f - alpha) + 1e-10f);
  }

  const float gr = g_rgb != nullptr ? g_rgb[3 * b] : 0.f;
  const float gg = g_rgb != nullptr ? g_rgb[3 * b + 1] : 0.f;
  const float gb = g_rgb != nullptr ? g_rgb[3 * b + 2] : 0.f;
  const float ga = g_acc != nullptr ? g_acc[b] : 0.f;
  const float gd = g_depth != nullptr ? g_depth[b] : 0.f;

  // pass 2: reverse scan
  float R = 0.f;
  for (int k = K - 1; k >= 0; --k) {
    const long long i = row + k;
    const float e = expf(-sigma[i] * dist[i]);
    const float alpha = 1.f - e;
    const float Tk = d_sigma[i];
    const float w = alpha * Tk;
    float s = ga;
    if (g_w != nullptr) s += g_w[i];
    if (rgb != nullptr) s += gr * rgb[3 * i] + gg * rgb[3 * i + 1] + gb * rgb[3 * i + 2];
    if (z != nullptr) s += gd * z[i];
    const float d_alpha = Tk * (s - R);
    d_sigma[i] = d_alpha * dist[i] * e;
    if (d_dist != nullptr) d_dist[i] = d_alpha * sigma[i] * e;
    if (d_rgb != nullptr) {
      d_rgb[3 * i] = w * gr;
      d_rgb[3 * i + 1] = w * gg;
      d_rgb[3 * i + 2] = w * gb;
    }
    if (d_z != nullptr) d_z[i] = w * gd;
    R = s * alpha + ((1.f - alpha) + 1e-10f) * R;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Every pointer is device memory
// that the caller allocated; a null rgb / z / output pointer skips that
// input or output. They launch on `stream` and return cudaGetLastError().
extern "C" int composite_fwd(const float* sigma, const float* dist,
                             const float* rgb, const float* z, float* weights,
                             float* rgb_map, float* acc, float* depth, int B,
                             int K, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  composite_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
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
  const int blocks = (B + kThreads - 1) / kThreads;
  composite_bwd_kernel<<<blocks, kThreads, 0, stream>>>(
      sigma, dist, rgb, z, g_w, g_rgb, g_acc, g_depth, d_sigma, d_dist, d_rgb,
      d_z, B, K);
  return static_cast<int>(cudaGetLastError());
}
