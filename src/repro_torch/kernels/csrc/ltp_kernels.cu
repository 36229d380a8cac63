// Hand-written Hopper (sm_90a) kernels for the LTP parameter-server hot loop
// and the Random-k compression baseline.
//
// Three memory-bound passes replace the JAX package's Pallas TPU kernels:
//
//   ltp_packet_reduce  <- src/repro/kernels/packet_reduce.py::packet_reduce
//       paper: out[i,j] = sum_w g[w,i,j] * m[w,i] / W
//       count: out[i,j] = sum_w g[w,i,j] * m[w,i] / max(sum_w m[w,i], 1)
//   ltp_dropfill       <- src/repro/kernels/dropfill.py::dropfill
//       out[i,j] = x[i,j] * (mask[i] * scale[i])   (f32 or bf16 in and out)
//   ltp_randomk        <- src/repro/kernels/randomk.py::randomk
//       out[i] = u[i] < k ? x[i] : 0               (f32 or bf16 x, f32 u)
//
// All three are bound by device-memory bytes, not by operations:
// packet_reduce does 2 flops per 4-byte element it reads, dropfill 1,
// randomk one compare per 8 bytes read. The design is the one that reads each
// input element once and writes each output element once.
//
// packet_reduce: one thread owns 4 consecutive outputs of one packet (1 when
// the payload is not a multiple of 4 or a pointer is not 16-byte aligned).
// The loop over the W workers runs inside the thread and accumulates in f32
// registers, with the deliverer count beside the sum in count mode. This takes
// the place of the TPU kernel's in-kernel W unroll: each input element is read
// once, each output written once, with no atomics, so the result is the same
// from run to run. Neighbouring threads read neighbouring 16-byte words of a
// worker's stream, so every warp load is coalesced. Ragged packet counts and
// payloads (360 floats is neither a multiple of 128 nor a power of two) are
// handled by a bounds check on the flat index: no padding copies.
//
// dropfill: an elementwise gate, 4 elements a thread on the f32 path. It may
// run in place (out == x), which is safe because each thread reads its
// elements before it writes them and touches no other thread's elements.
//
// randomk: a select over one flat stream, no padding. The TPU wrapper pads the
// stream to (256, 512) tiles with u = 2.0; here a bounds check takes the ragged
// end. On the f32 path a thread owns 4 elements and takes 16-byte loads of x and
// u when x, u and out are 16-byte aligned; the last thread of a length that is
// not a multiple of 4 (papernet's 696,234 floats leave 2) takes its 1-3
// elements one by one. Otherwise, and for bf16, one element a thread. k arrives
// as a float: the JAX kernel compares against k cast to float32, so an element
// whose u equals float(k) is dropped, as there.
//
// Each entry point launches on the caller's stream and returns the code of
// cudaGetLastError() right after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

inline unsigned int blocks_for(std::int64_t work_items) {
  return static_cast<unsigned int>((work_items + kThreads - 1) / kThreads);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
packet_reduce_kernel(const float* __restrict__ pkts,
                     const float* __restrict__ mask,
                     float* __restrict__ out, int n_workers,
                     std::int64_t n_packets, std::int64_t payload,
                     int count_mode) {
  const std::int64_t n_elems = n_packets * payload;
  const std::int64_t e0 =
      (static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= n_elems) return;
  // VEC divides the payload, so the VEC elements share one packet row
  const std::int64_t row = e0 / payload;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  float cnt = 0.f;
  for (int w = 0; w < n_workers; ++w) {
    const float m = __ldg(mask + static_cast<std::int64_t>(w) * n_packets + row);
    const float* src = pkts + static_cast<std::int64_t>(w) * n_elems + e0;
    if constexpr (VEC == 4) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(src));
      acc[0] += g.x * m;
      acc[1] += g.y * m;
      acc[2] += g.z * m;
      acc[3] += g.w * m;
    } else {
      acc[0] += __ldg(src) * m;
    }
    cnt += m;
  }
  const float denom = count_mode ? fmaxf(cnt, 1.f) : static_cast<float>(n_workers);
  if constexpr (VEC == 4) {
    float4 r;
    r.x = acc[0] / denom;
    r.y = acc[1] / denom;
    r.z = acc[2] / denom;
    r.w = acc[3] / denom;
    *reinterpret_cast<float4*>(out + e0) = r;
  } else {
    out[e0] = acc[0] / denom;
  }
}

__device__ __forceinline__ float gate_of(const float* mask, const float* scale,
                                         std::int64_t row) {
  float g = __ldg(mask + row);
  if (scale != nullptr) g *= __ldg(scale + row);
  return g;
}

// f32, 4 elements a thread; x and out may alias (in place)
__global__ void __launch_bounds__(kThreads)
dropfill_f32x4_kernel(const float* x, const float* __restrict__ mask,
                      const float* __restrict__ scale, float* out,
                      std::int64_t n_elems, std::int64_t payload) {
  const std::int64_t e0 =
      (static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e0 >= n_elems) return;
  const float g = gate_of(mask, scale, e0 / payload);
  float4 v = *reinterpret_cast<const float4*>(x + e0);
  v.x *= g;
  v.y *= g;
  v.z *= g;
  v.w *= g;
  *reinterpret_cast<float4*>(out + e0) = v;
}

// any payload: one element a thread, computed in f32, stored as T
template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropfill_kernel(const T* x, const float* __restrict__ mask,
                const float* __restrict__ scale, T* out, std::int64_t n_elems,
                std::int64_t payload) {
  const std::int64_t e =
      static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const float g = gate_of(mask, scale, e / payload);
  out[e] = from_f32<T>(to_f32<T>(x[e]) * g);
}

// f32, 4 elements a thread with 16-byte loads; the last thread takes the
// 1-3 elements of a length that is not a multiple of 4 one by one
__global__ void __launch_bounds__(kThreads)
randomk_f32x4_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     float k, float* __restrict__ out, std::int64_t n) {
  const std::int64_t e0 =
      (static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e0 + 4 <= n) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + e0));
    const float4 uv = __ldg(reinterpret_cast<const float4*>(u + e0));
    float4 r;
    r.x = uv.x < k ? xv.x : 0.f;
    r.y = uv.y < k ? xv.y : 0.f;
    r.z = uv.z < k ? xv.z : 0.f;
    r.w = uv.w < k ? xv.w : 0.f;
    *reinterpret_cast<float4*>(out + e0) = r;
  } else {
    for (std::int64_t e = e0; e < n; ++e) {
      out[e] = __ldg(u + e) < k ? __ldg(x + e) : 0.f;
    }
  }
}

// any alignment, f32 or bf16: one element a thread; a kept element is copied
// bit for bit, a dropped one is +0
template <typename T>
__global__ void __launch_bounds__(kThreads)
randomk_kernel(const T* __restrict__ x, const float* __restrict__ u, float k,
               T* __restrict__ out, std::int64_t n) {
  const std::int64_t e =
      static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  out[e] = __ldg(u + e) < k ? x[e] : from_f32<T>(0.f);
}

}  // namespace

extern "C" {

// packets (W, n, p) f32, mask (W, n) f32 -> out (n, p) f32, all contiguous.
int ltp_packet_reduce(const void* pkts, const void* mask, void* out,
                      int n_workers, long long n_packets, long long payload,
                      int count_mode, void* stream) {
  const std::int64_t n_elems = static_cast<std::int64_t>(n_packets) * payload;
  if (n_elems == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pkts);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  if (payload % 4 == 0 && aligned16(pkts) && aligned16(out)) {
    packet_reduce_kernel<4><<<blocks_for(n_elems / 4), kThreads, 0, s>>>(
        p, m, o, n_workers, n_packets, payload, count_mode);
  } else {
    packet_reduce_kernel<1><<<blocks_for(n_elems), kThreads, 0, s>>>(
        p, m, o, n_workers, n_packets, payload, count_mode);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out (n, p) of dtype code 0 = f32, 1 = bf16; mask, scale (n,) f32
// (scale may be null). out may equal x.
int ltp_dropfill(const void* x, const void* mask, const void* scale, void* out,
                 long long n_packets, long long payload, int dtype,
                 void* stream) {
  const std::int64_t n_elems = static_cast<std::int64_t>(n_packets) * payload;
  if (n_elems == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mask);
  const auto* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    if (payload % 4 == 0 && aligned16(x) && aligned16(out)) {
      dropfill_f32x4_kernel<<<blocks_for(n_elems / 4), kThreads, 0, s>>>(
          xi, m, sc, o, n_elems, payload);
    } else {
      dropfill_kernel<float><<<blocks_for(n_elems), kThreads, 0, s>>>(
          xi, m, sc, o, n_elems, payload);
    }
  } else if (dtype == 1) {
    dropfill_kernel<__nv_bfloat16><<<blocks_for(n_elems), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), m, sc,
        static_cast<__nv_bfloat16*>(out), n_elems, payload);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out (n,) of dtype code 0 = f32, 1 = bf16; u (n,) f32; all contiguous.
int ltp_randomk(const void* x, const void* u, float k, void* out, long long n,
                int dtype, void* stream) {
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* uf = static_cast<const float*>(u);
  if (dtype == 0) {
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    if (aligned16(x) && aligned16(u) && aligned16(out)) {
      randomk_f32x4_kernel<<<blocks_for((n + 3) / 4), kThreads, 0, s>>>(
          xi, uf, k, o, n);
    } else {
      randomk_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(xi, uf, k, o, n);
    }
  } else if (dtype == 1) {
    randomk_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), uf, k,
        static_cast<__nv_bfloat16*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ltp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
