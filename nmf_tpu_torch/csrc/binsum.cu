// Row scatter-add ("bin-sum") for sm_90a:
//   out = zeros(R, C); out[idx[n]] += vals[n] for idx[n] in [0, R),
// rows whose id lies outside [0, R) are dropped. vals is f32 or bf16 and
// is read in its own dtype; the sums are f32.
//
// Replaces the Pallas TPU kernel _binsum_kernel of
// nmf_tpu/ops/pallas/binsum.py (behind binsum_rows). The TPU version sorts
// the ids, cuts the sorted rows into 512-row output tiles and accumulates
// each tile with a one-hot matrix product, carrying the ids in a float lane
// (exact below 2^24). None of that is semantics: here the ids stay int32
// and collisions are resolved with atomics.
//
// What bounds it on the H100: bytes, then the L2's atomics. The train
// step's widest calls are the field's plane gradients, N = 393,216 or
// 786,432 bf16 rows of C = 288 or 160 (226-252 MB, ~0.07 ms at 3.35 TB/s);
// every run of equal ids then costs C atomic adds in the L2, and the line
// gradients pile thousands of rows onto each of 128-300 rows, where the
// atomics contend. The narrow calls (C = 6 to 44, N = 1,024 to 262,144)
// are set by latency: too few rows to keep the card's loads in flight.
//
// Design:
// - A thread owns one 16-byte vector of a row (4 f32 or 8 bf16 values) and
//   a run of consecutive rows; the `nv` threads of a row's vectors are
//   neighbours, so a warp covers one wide row, or several narrow ones, and
//   each row is read in coalesced 16-byte loads. Rows whose stride is not a
//   multiple of 16 bytes (C = 9 or 6 in f32) are read value by value, by
//   the same threads.
// - Consecutive rows mostly share an id (the samples of a ray sit in one
//   texel or line cell; segment sums and parent gathers come sorted, in
//   runs of up to 32 rows). A thread sums in f32 registers while the id
//   repeats and flushes once per run: float4 atomics where the output row
//   allows them (a vector of 8 bf16 takes two), which halve the field's
//   time against scalar ones; scalar atomics otherwise.
// - A thread issues the loads of kBatch rows before it adds any. The run
//   is the shortest (kBatch to kMaxRun rows) whose threads fit in one wave
//   of the card: the narrow calls stay parallel, the wide ones merge runs
//   of up to 64 rows, which the contended line gradients need.
// - The entry zeroes `out` on the stream (cudaMemsetAsync), then launches:
//   one call from the host. The atomics add in a varying order, so results
//   match a serial sum to f32 rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBatch = 8;     // rows whose loads a thread issues together
constexpr int kMaxRun = 64;   // rows a thread walks, at most
// threads resident at once: 132 SMs x 2 blocks (the kernel takes ~112
// registers a thread, so an SM holds two blocks of 256)
constexpr long long kWave = 132LL * 2 * kBlock;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // values in 16 bytes
  using Bits = unsigned int;
  __device__ static void unpack(uint4 w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Bits = unsigned short;
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  __device__ static void unpack(uint4 w, float* v) {
    const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

// The 16 bytes of values c0 .. c0 + kVec - 1 of one row, as stored (zero
// bits, +0 in either dtype, past the row's end). The words stay packed
// until they are added: a batch of rows costs 4 registers a row.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int c0,
                                          int C, bool vec) {
  constexpr int kVec = Elem<T>::kVec;
  using Bits = typename Elem<T>::Bits;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  const Bits* bits = reinterpret_cast<const Bits*>(row) + c0;
  union {
    uint4 w;
    Bits b[kVec];
  } u;
  u.w = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (c0 + k < C) u.b[k] = __ldg(bits + k);
  return u.w;
}

// out[id, c0 .. c0 + kVec - 1] += acc, dropped unless 0 <= id < R.
template <int kVec>
__device__ __forceinline__ void flush(float* __restrict__ out, int id, int R,
                                      int C, int c0, bool vec,
                                      const float* acc) {
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(R)) return;
  float* dst = out + static_cast<long long>(id) * C + c0;
  if (vec) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                            acc[4 * q + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (c0 + k < C) atomicAdd(dst + k, acc[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
    binsum_rows_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                       float* __restrict__ out, long long N, int C, int R,
                       int nv, int run, bool vec) {
  constexpr int kVec = Elem<T>::kVec;
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long g = t / nv;
  const int c0 = static_cast<int>(t - g * nv) * kVec;
  const long long start = g * run;
  if (start >= N) return;
  const long long end = start + run < N ? start + run : N;

  int cur = idx[start];
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  for (long long base = start; base < end; base += kBatch) {
    int ids[kBatch];
    uint4 w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (base + b < end) {
        ids[b] = idx[base + b];
        w[b] = load_vec(vals + (base + b) * C, c0, C, vec);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (base + b >= end) break;
      if (ids[b] != cur) {
        flush<kVec>(out, cur, R, C, c0, vec, acc);
        cur = ids[b];
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
      }
      float v[kVec];
      Elem<T>::unpack(w[b], v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] += v[k];
    }
  }
  flush<kVec>(out, cur, R, C, c0, vec, acc);
}

template <typename T>
void launch(const int* idx, const void* vals, float* out, long long N, int C,
            int R, cudaStream_t stream) {
  constexpr int kVec = Elem<T>::kVec;
  const int nv = (C + kVec - 1) / kVec;
  // the shortest run whose threads fit in one wave: short runs keep the
  // narrow calls parallel, long ones merge more of the wide calls' rows
  int run = kBatch;
  while (run < kMaxRun && (N + run - 1) / run * nv > kWave) run *= 2;
  const long long threads = (N + run - 1) / run * nv;
  const bool vec = C % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  binsum_rows_kernel<T><<<static_cast<unsigned>((threads + kBlock - 1) / kBlock),
                          kBlock, 0, stream>>>(
      idx, static_cast<const T*>(vals), out, N, C, R, nv, run, vec);
}

}  // namespace

// Plain C entry point, bound with ctypes. idx (N,) int32, vals (N, C) of
// dtype 0 (f32) or 1 (bf16), and out (R, C) f32 are contiguous device
// memory. Zeroes out, then launches, both on `stream`; returns the first
// CUDA error (cudaErrorInvalidValue for an unknown dtype or bad sizes).
extern "C" int binsum_rows(const int* idx, const void* vals, float* out,
                           long long N, int C, int R, int dtype,
                           cudaStream_t stream) {
  if (N < 0 || C <= 0 || R <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(R) * C * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return 0;
  if (dtype == 0)
    launch<float>(idx, vals, out, N, C, R, stream);
  else
    launch<__nv_bfloat16>(idx, vals, out, N, C, R, stream);
  return static_cast<int>(cudaGetLastError());
}
