// Hand-written Hopper (sm_90a) kernels for the LTP parameter-server hot loop
// and the Random-k compression baseline.
//
// Four passes replace the JAX package's Pallas TPU kernels:
//
//   ltp_packet_reduce  <- src/repro/kernels/packet_reduce.py::packet_reduce
//       paper: out[i,j] = sum_w g[w,i,j] * m[w,i] / W
//       count: out[i,j] = sum_w g[w,i,j] * m[w,i] / max(sum_w m[w,i], 1)
//   ltp_tree_reduce    <- src/repro/kernels/packet_reduce.py::tree_reduce
//       the same function in two levels, with the JAX arithmetic: per rack r
//       s_r = sum_{w in r} g*m, c_r = sum_{w in r} m, undone back to a raw sum
//       (paper: (s_r / n_r) * n_r; count: (s_r / max(c_r,1)) * max(c_r,1)),
//       added to the root's sum in rack order; then / W or / max(sum c_r, 1)
//   ltp_dropfill       <- src/repro/kernels/dropfill.py::dropfill
//       out[i,j] = x[i,j] * (mask[i] * scale[i])   (f32 or bf16 in and out)
//   ltp_dropfill_ef    the same pass in its error-feedback form, the gate
//       of src/repro/runtime/step.py (add, dropfill, sub) in one kernel:
//       s = x + res; sent = s * mask[i]; new_res = s - sent   (f32)
//   ltp_randomk        <- src/repro/kernels/randomk.py::randomk
//       out[i] = u[i] < k ? x[i] : 0               (f32 or bf16 x, f32 u)
//
// All four are bound by device-memory bytes, not by operations:
// packet_reduce and tree_reduce do 2 flops per 4-byte element they read,
// dropfill 1, randomk one compare per 8 bytes read. The design is the one
// that reads each input element once and writes each output element once.
//
// packet_reduce and tree_reduce: one pass each, no atomics, no padding, the
// same result from run to run. At the main path's (W, n, p) = (8, 1934, 360)
// f32 they must move 25.1 MB (the W packet streams, the W masks and the
// output), 7.5 us at 3.35 TB/s: bytes bind them, and the design is the one
// that keeps the most loads in flight. packet_reduce has W as a template
// parameter for W in {2, 4, 8, 16, 32} (a loop otherwise); a thread owns 2
// float4 of output (1 above W = 8, where 2W float4 would not fit in the
// registers), issues every worker's 16-byte loads before its first add, sums
// in f32 in worker order and writes 16-byte stores. tree_reduce is one launch
// of the same pass, one float4 a thread, looping rack by rack over the
// wrapper's `members` (CSR offsets `rack_ptr`) with one rack partial in
// registers; every thread reads the same few entries of those two, so they
// come through L1 and W has no fixed limit. Packet loads bypass L1 and ask
// L2 for the whole 256-byte span around them
// (ld.global.nc.L1::no_allocate.L2::256B), since every byte is read once.
// Staging the stream in shared memory through cp.async.bulk copies and
// mbarriers measured slower, in the step and alone (PERF.md §6).
// A payload that is not a multiple of 4, or packets or output not 16-byte
// aligned, take one element a thread with the same arithmetic, chosen by that
// shape and alignment test before the launch.
//
// dropfill: one elementwise pass in two forms (one template). Every port
// caller gates with error feedback, which the JAX package runs as three
// passes around its dropfill: the EF form reads x, res and the mask and
// writes sent and new_res, 16 bytes an element where the three passes move
// 32, in one launch where they take three. Each op is rounded as torch's
// (__fadd_rn, __fmul_rn, __fsub_rn, so that nvcc cannot contract s - s * m
// into an FMA), so the EF form is bit for bit the plain route. At one
// gradient's (1934, 360) it moves 11.15 MB, 3.3 us at 3.35 TB/s, and the
// launch and the grid's drain weigh about as much again; at the bsp step's
// (15472, 360), 89.2 MB. Design: one float4 a thread over the flat stream,
// the packet row found by a 32-bit divide (64-bit only for streams of 2^32
// float4 or more), x and res read with the 256-byte L2 fetch of the packet
// stream, sent stored plainly (packet_reduce reads it next) and new_res
// evict-first (it is read only in the next round), which keeps sent in the
// L2: packet_reduce after the gate takes 0.0060 ms in the bsp step, where it
// took 0.0091 ms after the three passes. Measured in the profiled bsp step
// and async apply (PERF.md §6) and not kept: 2 or 4 float4 a thread (the
// apply's gate 13 % and 29 % slower), a warp a packet row with no divide
// (the bsp step's gate 18 % slower), new_res stored plainly (packet_reduce
// after it 20 % slower), plain loads (40 % slower there), and programmatic
// dependent launch (faster back to back, no faster in the step). The plain
// gate may run in place (out == x): each thread reads its elements before
// it writes them and touches no other thread's. A payload that is not a
// multiple of 4, a stream not 16-byte aligned, and bf16 take one element a
// thread.
//
// randomk: a select over one flat stream, no padding. It moves 12 bytes an
// element (x and u read, out written) for one compare: at the Fig 5 path's
// 696,234 floats 8.35 MB, 2.49 us at an H100's 3.35 TB/s, so the launch, the
// ramp to full memory rate and the grid's tail weigh as much as the stream.
// The TPU wrapper pads the stream to (256, 512) tiles with u = 2.0; here a
// bounds check takes the ragged end. On the f32 path, when x, u and out are
// 16-byte aligned, a thread owns 4 elements and reads x and u with 16-byte
// loads that bypass L1 and ask L2 for the whole 256-byte span around them,
// the fetch of the packet stream; that fetch is what shortens the ramp from
// device memory. Its stores are plain, not evict-first: the caller's next op
// (new_res = flat - kept) reads out and x again from L2. The last thread of a
// length that is not a multiple of 4 (papernet's 696,234 floats leave 2) takes
// its 1-3 elements one by one. A misaligned stream takes one element a
// thread, and so does bf16, which is on no path of the port. A balanced wave
// (a grid that is a multiple of the SM count, 1-4 float4 a thread, all loads
// in flight before the first select) measured no faster inside the Fig 5
// step and slower on inputs in L2 (PERF.md §6). k arrives as a float: the
// JAX kernel compares against k cast to float32, so an element whose u
// equals float(k) is dropped, as there; a kept element is copied bit for bit.
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

// ---------------------------------------------------------------------------
// The PS reduction: packet_reduce (workers 0..W-1, one plain sum) and
// tree_reduce (racks of `members`, offsets `rack_ptr`), one pass each.

template <int V>
struct Vec {
  float v[V];
};

// A read of a stream that is read once (the packets, dropfill's x and res,
// randomk's x and u): kept out of L1, and an L2 miss fetches the whole
// 256-byte span around it from device memory.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

template <int V>
__device__ __forceinline__ Vec<V> ldg_vec(const float* p, std::int64_t i) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 g = ld_stream(reinterpret_cast<const float4*>(p) + i);
    r.v[0] = g.x;
    r.v[1] = g.y;
    r.v[2] = g.z;
    r.v[3] = g.w;
  } else {
    r.v[0] = __ldg(p + i);
  }
  return r;
}

// The masked sums of U output vectors of V elements, vector q[u] of packet
// row[u]. TREE sums the racks of `members` / `rack_ptr` in order, each
// rack's partial s_r = sum g*m and c_r = sum m over its members in member
// order, and undoes the rack's normalisation as the JAX tree_reduce does:
// acc += (s_r / k) * k, the product rounded before the add, with k the rack
// size (paper) or max(c_r, 1) (count); cnt += c_r. Otherwise the W workers
// are one plain sum. Then out = acc / W (paper) or acc / max(cnt, 1).
// W > 0 (the plain sum only) unrolls the workers: every thread issues all
// U * W packet loads and their mask loads before its first add, so they are
// in flight together. W == 0 loops over the workers (TREE: rack by rack),
// one worker's U loads at a time.
template <bool TREE, int W, int V, int U>
__device__ __forceinline__ void reduce_vecs(
    Vec<V> (&out)[U], const float* __restrict__ pkts,
    const float* __restrict__ mask, const std::int64_t (&q)[U],
    const std::int64_t (&row)[U], std::int64_t n_vec, std::int64_t n_packets,
    const int* __restrict__ members, const int* __restrict__ rack_ptr,
    int n_workers, int n_racks, int count_mode) {
  Vec<V> acc[U], s[U];
  float cnt[U], c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[u].v[i] = s[u].v[i] = 0.f;
    cnt[u] = c[u] = 0.f;
  }
  auto add = [&](int u, const Vec<V>& g, float m) {
#pragma unroll
    for (int i = 0; i < V; ++i) s[u].v[i] += g.v[i] * m;
    c[u] += m;
  };
  auto close_rack = [&](int rack_size) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float k =
          count_mode ? fmaxf(c[u], 1.f) : static_cast<float>(rack_size);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[u].v[i] += __fmul_rn(s[u].v[i] / k, k);
        s[u].v[i] = 0.f;
      }
      cnt[u] += c[u];
      c[u] = 0.f;
    }
  };
  if constexpr (W > 0) {
    static_assert(!TREE, "the tree loops over its racks");
    Vec<V> g[U][W];
    float m[U][W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        g[u][w] = ldg_vec<V>(pkts, w * n_vec + q[u]);
        m[u][w] = __ldg(mask + w * n_packets + row[u]);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int u = 0; u < U; ++u) add(u, g[u][w], m[u][w]);
    }
  } else if constexpr (TREE) {
    for (int r = 0; r < n_racks; ++r) {
      const int j0 = __ldg(rack_ptr + r), j1 = __ldg(rack_ptr + r + 1);
      for (int j = j0; j < j1; ++j) {
        const int w = __ldg(members + j);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          add(u, ldg_vec<V>(pkts, w * n_vec + q[u]),
              __ldg(mask + w * n_packets + row[u]));
        }
      }
      close_rack(j1 - j0);
    }
  } else {
    for (int w = 0; w < n_workers; ++w) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        add(u, ldg_vec<V>(pkts, w * n_vec + q[u]),
            __ldg(mask + w * n_packets + row[u]));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if constexpr (!TREE) {
      acc[u] = s[u];
      cnt[u] = c[u];
    }
    const float denom =
        count_mode ? fmaxf(cnt[u], 1.f) : static_cast<float>(n_workers);
#pragma unroll
    for (int i = 0; i < V; ++i) out[u].v[i] = acc[u].v[i] / denom;
  }
}

// A block owns U * kThreads consecutive output vectors of V elements; thread
// t takes vectors t, t + kThreads, ... A vector past the end is loaded as the
// last one (so every load is issued unconditionally) and not stored.
template <bool TREE, int W, int V, int U>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ pkts, const float* __restrict__ mask,
              float* __restrict__ out, const int* __restrict__ members,
              const int* __restrict__ rack_ptr, int n_workers, int n_racks,
              std::int64_t n_packets, std::int64_t payload, int count_mode) {
  const std::int64_t n_vec = n_packets * payload / V;
  const std::int64_t q0 =
      static_cast<std::int64_t>(blockIdx.x) * (U * kThreads) + threadIdx.x;
  if (q0 >= n_vec) return;
  std::int64_t q[U], row[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const std::int64_t qu = q0 + u * kThreads;
    q[u] = qu < n_vec ? qu : n_vec - 1;
    row[u] = q[u] * V / payload;
  }
  Vec<V> r[U];
  reduce_vecs<TREE, W, V, U>(r, pkts, mask, q, row, n_vec, n_packets, members,
                             rack_ptr, n_workers, n_racks, count_mode);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (q0 + u * kThreads >= n_vec) break;
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(out)[q[u]] =
          make_float4(r[u].v[0], r[u].v[1], r[u].v[2], r[u].v[3]);
    } else {
      out[q[u]] = r[u].v[0];
    }
  }
}

// packet_reduce: 2 float4 a thread up to W = 8, 1 above, where 2 * W float4
// would not fit in the registers. tree_reduce: 1 float4 a thread, whose
// divides at each rack's close want the threads.
template <bool TREE, int W>
void launch_x4(const float* p, const float* m, float* o, const int* mem,
               const int* ptr, int n_workers, int n_racks,
               std::int64_t n_packets, std::int64_t payload, int count_mode,
               cudaStream_t s) {
  constexpr int U = TREE || W > 8 ? 1 : 2;
  const std::int64_t n_vec = n_packets * payload / 4;
  reduce_kernel<TREE, W, 4, U>
      <<<blocks_for((n_vec + U - 1) / U), kThreads, 0, s>>>(
          p, m, o, mem, ptr, n_workers, n_racks, n_packets, payload,
          count_mode);
}

// 16-byte vectors when the payload is a multiple of 4 and the packets and
// the output are 16-byte aligned, the plain sum's W unrolled for W in
// {2, 4, 8, 16, 32}; else one element a thread and a loop over the workers
template <bool TREE>
int launch_reduce(const float* p, const float* m, float* o, const int* mem,
                  const int* ptr, int n_workers, int n_racks,
                  std::int64_t n_packets, std::int64_t payload, int count_mode,
                  cudaStream_t s) {
  const std::int64_t n_elems = n_packets * payload;
  if (n_elems == 0) return 0;
  if (payload % 4 == 0 && aligned16(p) && aligned16(o)) {
    auto launch = launch_x4<TREE, 0>;
    if constexpr (!TREE) {
      switch (n_workers) {
        case 2: launch = launch_x4<TREE, 2>; break;
        case 4: launch = launch_x4<TREE, 4>; break;
        case 8: launch = launch_x4<TREE, 8>; break;
        case 16: launch = launch_x4<TREE, 16>; break;
        case 32: launch = launch_x4<TREE, 32>; break;
        default: break;
      }
    }
    launch(p, m, o, mem, ptr, n_workers, n_racks, n_packets, payload,
           count_mode, s);
  } else {
    reduce_kernel<TREE, 0, 1, 1><<<blocks_for(n_elems), kThreads, 0, s>>>(
        p, m, o, mem, ptr, n_workers, n_racks, n_packets, payload,
        count_mode);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The gate: dropfill in its two forms, one pass each.
//   plain (the TPU kernel's function): out = x * (mask * scale)[row]
//   error feedback (EF):               s = x + res; out = s * mask[row];
//                                      new_res = s - out

struct Gate {
  const float* x;      // packets (plain) or flat (EF)
  const float* res;    // EF: the residual
  const float* mask;   // (n,)
  const float* scale;  // plain: (n,) or null; EF: null
  float* out;          // plain: may be x (in place); EF: sent
  float* new_res;      // EF
};

__device__ __forceinline__ float gate_of(const Gate& a, std::int64_t row) {
  float g = __ldg(a.mask + row);
  if (a.scale != nullptr) g = __fmul_rn(g, __ldg(a.scale + row));
  return g;
}

// The rounded operations, so that nvcc cannot contract s - s * g into an
// FMA: each result is torch's add, mul and sub in f32, bit for bit.
template <bool EF>
__device__ __forceinline__ void gate_vec(const float4& x, const float4& r,
                                         float g, float4& out,
                                         float4& new_res) {
  if constexpr (EF) {
    const float4 s = make_float4(__fadd_rn(x.x, r.x), __fadd_rn(x.y, r.y),
                                 __fadd_rn(x.z, r.z), __fadd_rn(x.w, r.w));
    out = make_float4(__fmul_rn(s.x, g), __fmul_rn(s.y, g),
                      __fmul_rn(s.z, g), __fmul_rn(s.w, g));
    new_res = make_float4(__fsub_rn(s.x, out.x), __fsub_rn(s.y, out.y),
                          __fsub_rn(s.z, out.z), __fsub_rn(s.w, out.w));
  } else {
    out = make_float4(__fmul_rn(x.x, g), __fmul_rn(x.y, g),
                      __fmul_rn(x.z, g), __fmul_rn(x.w, g));
  }
}

// One float4 a thread over the flat stream of n_vec float4; the row of
// float4 q is q / row_vecs, in I (32 bits unless the stream is longer).
// x and res come through the 256-byte L2 fetch, both loads issued before
// the gate is read; sent is stored plainly (packet_reduce reads it next),
// new_res evict-first (read again only in the next round), so that the L2
// keeps sent. In place (plain, out == x) is safe: a thread reads its
// float4 before it writes it and no thread reads another's, so the
// non-coherent load never sees a write.
template <bool EF, typename I>
__global__ void __launch_bounds__(kThreads)
dropfill_x4_kernel(Gate a, I n_vec, I row_vecs) {
  const I q = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_vec) return;
  const float4 x = ld_stream(reinterpret_cast<const float4*>(a.x) + q);
  float4 r{};
  if constexpr (EF) r = ld_stream(reinterpret_cast<const float4*>(a.res) + q);
  float4 o, nr;
  gate_vec<EF>(x, r, gate_of(a, q / row_vecs), o, nr);
  reinterpret_cast<float4*>(a.out)[q] = o;
  if constexpr (EF) __stcs(reinterpret_cast<float4*>(a.new_res) + q, nr);
}

// any payload or alignment: one element a thread, computed in f32, stored
// as T (EF: f32 only)
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

template <typename T, bool EF>
__global__ void __launch_bounds__(kThreads)
dropfill_kernel(const T* x, Gate a, T* out, std::int64_t n_elems,
                std::int64_t payload) {
  const std::int64_t e =
      static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const float g = gate_of(a, e / payload);
  if constexpr (EF) {
    const float s = __fadd_rn(to_f32<T>(x[e]), __ldg(a.res + e));
    const float o = __fmul_rn(s, g);
    out[e] = from_f32<T>(o);
    a.new_res[e] = __fsub_rn(s, o);
  } else {
    out[e] = from_f32<T>(__fmul_rn(to_f32<T>(x[e]), g));
  }
}

// 16-byte vectors when the payload is a multiple of 4 and every stream is
// 16-byte aligned (32-bit indices below 2^32 float4), else one element a
// thread
template <bool EF>
int launch_gate(const Gate& a, std::int64_t n_packets, std::int64_t payload,
                cudaStream_t s) {
  const std::int64_t n_elems = n_packets * payload;
  if (n_elems == 0) return 0;
  const bool vec = payload % 4 == 0 && aligned16(a.x) && aligned16(a.out) &&
                   (!EF || (aligned16(a.res) && aligned16(a.new_res)));
  if (vec) {
    const std::int64_t n_vec = n_elems / 4, row_vecs = payload / 4;
    if (n_vec + kThreads < (std::int64_t{1} << 32)) {
      dropfill_x4_kernel<EF, std::uint32_t>
          <<<blocks_for(n_vec), kThreads, 0, s>>>(
              a, static_cast<std::uint32_t>(n_vec),
              static_cast<std::uint32_t>(row_vecs));
    } else {
      dropfill_x4_kernel<EF, std::int64_t>
          <<<blocks_for(n_vec), kThreads, 0, s>>>(a, n_vec, row_vecs);
    }
  } else {
    dropfill_kernel<float, EF><<<blocks_for(n_elems), kThreads, 0, s>>>(
        a.x, a, a.out, n_elems, payload);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32, 4 elements a thread with 16-byte loads that ask L2 for the whole
// 256-byte span around them; the last thread takes the 1-3 elements of a
// length that is not a multiple of 4 one by one
__global__ void __launch_bounds__(kThreads)
randomk_f32x4_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     float k, float* __restrict__ out, std::int64_t n) {
  const std::int64_t e0 =
      (static_cast<std::int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e0 + 4 <= n) {
    const float4 xv = ld_stream(reinterpret_cast<const float4*>(x + e0));
    const float4 uv = ld_stream(reinterpret_cast<const float4*>(u + e0));
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
  return launch_reduce<false>(
      static_cast<const float*>(pkts), static_cast<const float*>(mask),
      static_cast<float*>(out), nullptr, nullptr, n_workers, 1, n_packets,
      payload, count_mode, static_cast<cudaStream_t>(stream));
}

// packets (W, n, p) f32, mask (W, n) f32 -> out (n, p) f32, all contiguous;
// members (W,) int32 the workers grouped by rack, rack_ptr (n_racks + 1,)
// int32 the offset of each rack's first member in `members`, on the device.
int ltp_tree_reduce(const void* pkts, const void* mask, const void* members,
                    const void* rack_ptr, void* out, int n_workers,
                    int n_racks, long long n_packets, long long payload,
                    int count_mode, void* stream) {
  return launch_reduce<true>(
      static_cast<const float*>(pkts), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<const int*>(members),
      static_cast<const int*>(rack_ptr), n_workers, n_racks, n_packets,
      payload, count_mode, static_cast<cudaStream_t>(stream));
}

// x, out (n, p) of dtype code 0 = f32, 1 = bf16; mask, scale (n,) f32
// (scale may be null). out may equal x.
int ltp_dropfill(const void* x, const void* mask, const void* scale, void* out,
                 long long n_packets, long long payload, int dtype,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Gate a{static_cast<const float*>(x), nullptr,
               static_cast<const float*>(mask),
               static_cast<const float*>(scale), static_cast<float*>(out),
               nullptr};
  if (dtype == 0) return launch_gate<false>(a, n_packets, payload, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const std::int64_t n_elems = static_cast<std::int64_t>(n_packets) * payload;
  if (n_elems == 0) return 0;
  dropfill_kernel<__nv_bfloat16, false>
      <<<blocks_for(n_elems), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), a,
          static_cast<__nv_bfloat16*>(out), n_elems,
          static_cast<std::int64_t>(payload));
  return static_cast<int>(cudaGetLastError());
}

// The EF form: flat, residual, sent, new_res (n, p) f32, mask (n,) f32, all
// contiguous; sent and new_res are fresh (they alias nothing).
int ltp_dropfill_ef(const void* flat, const void* residual, const void* mask,
                    void* sent, void* new_res, long long n_packets,
                    long long payload, void* stream) {
  const Gate a{static_cast<const float*>(flat),
               static_cast<const float*>(residual),
               static_cast<const float*>(mask), nullptr,
               static_cast<float*>(sent), static_cast<float*>(new_res)};
  return launch_gate<true>(a, n_packets, payload,
                           static_cast<cudaStream_t>(stream));
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
