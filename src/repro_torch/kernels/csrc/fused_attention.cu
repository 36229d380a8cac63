// Fused full attention (no causal mask, no window) for Hopper (sm_90a),
// forward and backward, after FlashAttention-2.
//
// Replaces no Pallas kernel: the JAX package leaves attention to XLA. On a
// CUDA tensor it takes the place of the port's plain path, the Python loop
// over query chunks of models/attention.py::multi_head_attention, which
// issues some 20 operations a chunk and passes over the float32 (B, H, cq,
// Sk) scores about ten times. Whisper's encoder self-attention (1,500 x
// 1,500) and its cross-attention (Sq x 1,500) take it.
//
// Bound: tensor-core operations at the encoder's 1,500 x 1,500 (4 B H Sq Sk
// hd forward, twice that backward, against q, k, v and o read once), and
// device-memory bytes at Sq = 1 (decode's cross-attention reads all of K and
// V for one query row). The scores never reach device memory.
//
// Layouts are the port's: q (B, Sq, H, hd), k and v (B, Sk, KV, hd) with any
// strides but a unit one on hd (the wrapper passes rows 16-byte aligned);
// o, dq like q and dk, dv like k (dk and dv share strides); lse and the
// rows' D (B, H, Sq) float32, contiguous. Query head h reads KV head h / G,
// G = H / KV. Rows past Sq and Sk are masked.
//
// Rounding follows the plain path (_sdpa and its autograd): S = QK^T
// accumulated in float32 and rounded to the inputs' dtype, then scaled in
// float32; max, exp and sums in float32; P normalised in float32, then
// rounded into the PV product; in the backward dP = dO V^T rounded likewise,
// the rows' D = sum_j P dP in float32 from the unrounded P, and
// dS = P (dP - D) scale rounded into the dQ and dK products. Where the
// weights are near uniform every weight rounds the same way, so a rounding
// point moved shifts a whole row: a one-pass online softmax, which rounds P
// before it is normalised, moved the loss of a whole-size Whisper step by
// ten times a one-ulp nudge of its weights. So the forward passes over the
// keys twice (the rows' max and sum first), and the dQ kernel twice (D
// first, which FlashAttention-2 takes as rowsum(dO o O) from the rounded P).
//
// bfloat16 design: a block of 4 warps owns a 64-row tile (queries in the
// forward and dQ kernels, keys in the dK/dV kernel), 16 rows a warp, and
// streams 64-row tiles of the other side through shared memory, double
// buffered with cp.async (zero-filled past the end). Its own tile stays in
// registers as mma.sync A fragments; every product is mma.sync m16n8k16
// (bf16 in, f32 accumulate), the streamed tile read by ldmatrix (.trans
// where the product needs it [k][n]). A product's f32 result becomes the
// next product's A fragment in registers, as in FlashAttention-2. Rows are
// padded by 16 bytes in shared memory, so ldmatrix's eight rows fall in
// eight bank groups. The backward is a dQ kernel (one block a query tile,
// which also writes D) and then a dK/dV kernel (one block a key tile and KV
// head, looping over the query tiles of every head that reads it): each
// output is written once, with no atomics, so two runs give the same bits.
// Fixed tiles, nothing autotuned. mma.sync runs on Hopper's tensor cores at
// a fraction of wgmma's rate; wgmma with TMA loads is the next step.
//
// float32 inputs (no TF32 anywhere) take a plain CUDA-core form of the same
// three kernels, one thread a row; no training cell runs it.
//
// Entry points (extern "C", return a cudaError_t code): ltp_attn_fwd,
// ltp_attn_bwd (the dQ kernel, then the dK/dV kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // rows of a block's tile and of a streamed one
constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kF32Rows = 64;    // float32 form: threads a block, a row each
constexpr int kF32Tile = 32;    // float32 form: rows of a streamed tile
// the bfloat16 forward's blocks a multiprocessor holds: four (128
// registers a thread) ran its encoder shape in 1.21 ms against 1.34-2.00
// at three (165 registers); the backward kernels keep up to 255 registers
// (two blocks), where a cap spilled and measured no faster
constexpr int kFwdBlocks = 4;

// strides (elements) of q, k, v, o or dO, dq, dk and dv: batch, seq, head
enum { kQ = 0, kK, kV, kO, kDQ, kDKV };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // the forward's output; the backward's dO
  void* out;           // the forward's O; the backward's dQ
  void* dk;
  void* dv;
  float* lse;
  float* rows;         // the backward's D
  long long st[6][3];
  int b, h, kvh, g, sq, sk;
  float scale;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to bfloat16 and back
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warp's accumulators: c[j][e] holds row (lane / 4) + 8 (e / 2) of the
// warp's 16 and column 8 j + 2 (lane % 4) + (e % 2).
__device__ __forceinline__ int col_of(int j, int e, int lane) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

// 64 rows of hd bf16 (row stride rs elements) -> shared [64][HD + 8]; rows
// from n on zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long rs, int n, int tid) {
  constexpr int kChunks = HD / 8, kLd = HD + 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < n;
    cp16(saddr(s + r * kLd + c * 8), g + (ok ? r * rs : 0) + c * 8, ok);
  }
}

// 64 floats (contiguous) -> shared, from n on zero-filled
__device__ __forceinline__ void load_row(float* s, const float* g, int n,
                                         int tid) {
  if (tid < kTile) {
    const bool ok = tid < n;
    cp4(saddr(s + tid), g + (ok ? tid : 0), ok);
  }
}

// the warp's 16 rows of a shared [64][HD + 8] tile as A fragments
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const bf16* s, int w, int lane) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm(a[kk], saddr(s + (w * 16 + (lane & 15)) * kLd + kk * 16 +
                      (lane >> 4) * 8));
}

// c (16 x 64) += a (16 x HD) b^T, b a shared [64][HD + 8] tile
template <int HD>
__device__ __forceinline__ void mm_abt(float (&c)[8][4],
                                       const uint32_t (&a)[HD / 16][4],
                                       const bf16* b, int lane) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      ldsm(r, saddr(b + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                    kk * 16 + ((lane >> 3) & 1) * 8));
      mma(c[2 * jp], a[kk], r[0], r[1]);
      mma(c[2 * jp + 1], a[kk], r[2], r[3]);
    }
  }
}

// c (16 x HD) += a (16 x 64) b, b a shared [64][HD + 8] tile
template <int HD>
__device__ __forceinline__ void mm_ab(float (&c)[HD / 8][4],
                                      const uint32_t (&a)[4][4],
                                      const bf16* b, int lane) {
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < HD / 16; ++jp) {
      uint32_t r[4];
      ldsm_t(r, saddr(b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              kLd +
                      jp * 16 + (lane >> 4) * 8));
      mma(c[2 * jp], a[kk], r[0], r[1]);
      mma(c[2 * jp + 1], a[kk], r[2], r[3]);
    }
  }
}

// a (16 x 64) rounded to bf16 as A fragments
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// the warp's 16 rows of c (16 x HD) -> bf16 rows of out (row stride rs),
// rows from n on skipped
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, long long rs,
                                           const float (&c)[HD / 8][4], int w,
                                           int lane, int n) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w * 16 + (lane >> 2) + 8 * half;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + r * rs + 8 * j + 2 * (lane & 3)) =
          pack(c[j][2 * half], c[j][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: forward
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
    attn_fwd(const Params p) {
  constexpr int kLd = HD + 8, kSz = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kSz;        // [2][64][kLd]
  bf16* sv = sk + 2 * kSz;    // [2][64][kLd]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h, kh = h / p.g;
  const int m0 = blockIdx.x * kTile, nq = min(kTile, p.sq - m0);
  const long long ks = p.st[kK][1], vs = p.st[kV][1];
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.st[kQ][0] +
                  h * p.st[kQ][2] + m0 * p.st[kQ][1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.st[kK][0] +
                  kh * p.st[kK][2];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.st[kV][0] +
                  kh * p.st[kV][2];
  const int nblk = (p.sk + kTile - 1) / kTile;

  load_tile<HD>(sq, q, p.st[kQ][1], nq, tid);
  load_tile<HD>(sk, k, ks, p.sk, tid);
  cp_commit();
  uint32_t qa[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // pass 1: the rows' max and sum
  for (int j = 0; j < nblk; ++j) {
    if (j + 1 < nblk)
      load_tile<HD>(sk + ((j + 1) & 1) * kSz, k + (j + 1) * kTile * ks, ks,
                    p.sk - (j + 1) * kTile, tid);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (j == 0) load_a<HD>(qa, sq, w, lane);
    float s[8][4];
    zero(s);
    mm_abt<HD>(s, qa, sk + (j & 1) * kSz, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j * kTile + col_of(c, e, lane) < p.sk;
        s[c][e] = ok ? rnd(s[c][e]) * p.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      l[r] *= __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(s[c][e] - m[e >> 1]);
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }

  // pass 2: P normalised, rounded, into PV
  load_tile<HD>(sk, k, ks, p.sk, tid);
  load_tile<HD>(sv, v, vs, p.sk, tid);
  cp_commit();
  float o[HD / 8][4];
  zero(o);
  for (int j = 0; j < nblk; ++j) {
    if (j + 1 < nblk) {
      const int nxt = (j + 1) & 1, left = p.sk - (j + 1) * kTile;
      load_tile<HD>(sk + nxt * kSz, k + (j + 1) * kTile * ks, ks, left, tid);
      load_tile<HD>(sv + nxt * kSz, v + (j + 1) * kTile * vs, vs, left, tid);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    float s[8][4];
    zero(s);
    mm_abt<HD>(s, qa, sk + (j & 1) * kSz, lane);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j * kTile + col_of(c, e, lane) < p.sk;
        s[c][e] = ok ? __expf(rnd(s[c][e]) * p.scale - m[e >> 1]) *
                           inv[e >> 1]
                     : 0.f;
      }
    uint32_t pa[4][4];
    to_a(pa, s);
    mm_ab<HD>(o, pa, sv + (j & 1) * kSz, lane);
    __syncthreads();
  }

  store_rows<HD>(static_cast<bf16*>(p.out) + b * p.st[kO][0] +
                     h * p.st[kO][2] + m0 * p.st[kO][1],
                 p.st[kO][1], o, w, lane, nq);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w * 16 + (lane >> 2) + 8 * r;
      if (row < nq)
        p.lse[static_cast<long long>(bh) * p.sq + m0 + row] =
            m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: backward, dQ (and the rows' D)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params p) {
  constexpr int kLd = HD + 8, kSz = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kSz;
  bf16* sk = sdo + kSz;       // [2][64][kLd]
  bf16* sv = sk + 2 * kSz;    // [2][64][kLd]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.h, h = bh % p.h, kh = h / p.g;
  const int m0 = blockIdx.x * kTile, nq = min(kTile, p.sq - m0);
  const long long ks = p.st[kK][1], vs = p.st[kV][1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.st[kK][0] +
                  kh * p.st[kK][2];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.st[kV][0] +
                  kh * p.st[kV][2];
  const long long row0 = static_cast<long long>(bh) * p.sq + m0;
  const int nblk = (p.sk + kTile - 1) / kTile;

  load_tile<HD>(sq, static_cast<const bf16*>(p.q) + b * p.st[kQ][0] +
                        h * p.st[kQ][2] + m0 * p.st[kQ][1],
                p.st[kQ][1], nq, tid);
  load_tile<HD>(sdo, static_cast<const bf16*>(p.o) + b * p.st[kO][0] +
                         h * p.st[kO][2] + m0 * p.st[kO][1],
                p.st[kO][1], nq, tid);
  load_tile<HD>(sk, k, ks, p.sk, tid);
  load_tile<HD>(sv, v, vs, p.sk, tid);
  cp_commit();
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w * 16 + (lane >> 2) + 8 * r;
    lse[r] = row < nq ? p.lse[row0 + row] : 0.f;
  }
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float d[2] = {0.f, 0.f};

#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float dq[HD / 8][4];
    if (pass == 1) {
      load_tile<HD>(sk, k, ks, p.sk, tid);
      load_tile<HD>(sv, v, vs, p.sk, tid);
      cp_commit();
      zero(dq);
    }
    for (int j = 0; j < nblk; ++j) {
      if (j + 1 < nblk) {
        const int nxt = (j + 1) & 1, left = p.sk - (j + 1) * kTile;
        load_tile<HD>(sk + nxt * kSz, k + (j + 1) * kTile * ks, ks, left,
                      tid);
        load_tile<HD>(sv + nxt * kSz, v + (j + 1) * kTile * vs, vs, left,
                      tid);
      }
      cp_commit();
      cp_wait_one();
      __syncthreads();
      if (pass == 0 && j == 0) {
        load_a<HD>(qa, sq, w, lane);
        load_a<HD>(da, sdo, w, lane);
      }
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      mm_abt<HD>(s, qa, sk + (j & 1) * kSz, lane);
      mm_abt<HD>(dp, da, sv + (j & 1) * kSz, lane);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = j * kTile + col_of(c, e, lane) < p.sk;
          const float pr =
              ok ? __expf(rnd(s[c][e]) * p.scale - lse[e >> 1]) : 0.f;
          const float dpr = rnd(dp[c][e]);
          if (pass == 0)
            d[e >> 1] += pr * dpr;
          else
            s[c][e] = pr * (dpr - d[e >> 1]) * p.scale;
        }
      if (pass == 1) {
        uint32_t dsa[4][4];
        to_a(dsa, s);
        mm_ab<HD>(dq, dsa, sk + (j & 1) * kSz, lane);
      }
      __syncthreads();
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] = quad_sum(d[r]);
        const int row = w * 16 + (lane >> 2) + 8 * r;
        if ((lane & 3) == 0 && row < nq) p.rows[row0 + row] = d[r];
      }
    } else {
      store_rows<HD>(static_cast<bf16*>(p.out) + b * p.st[kDQ][0] +
                         h * p.st[kDQ][2] + m0 * p.st[kDQ][1],
                     p.st[kDQ][1], dq, w, lane, nq);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: backward, dK and dV
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Params p) {
  constexpr int kLd = HD + 8, kSz = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kSz;
  bf16* sq = sv + kSz;        // [2][64][kLd]
  bf16* sdo = sq + 2 * kSz;   // [2][64][kLd]
  float* slse = reinterpret_cast<float*>(sdo + 2 * kSz);   // [2][64]
  float* sd = slse + 2 * kTile;                            // [2][64]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bkh = blockIdx.y, b = bkh / p.kvh, kh = bkh % p.kvh;
  const int n0 = blockIdx.x * kTile, nk = min(kTile, p.sk - n0);
  const int nqb = (p.sq + kTile - 1) / kTile, total = p.g * nqb;
  const long long qs = p.st[kQ][1], os = p.st[kO][1];

  // tile it: query tile it % nqb of head kh G + it / nqb
  auto issue = [&](int it, int buf) {
    const int h = kh * p.g + it / nqb, m0 = (it % nqb) * kTile;
    const int nq = p.sq - m0;
    load_tile<HD>(sq + buf * kSz, static_cast<const bf16*>(p.q) +
                                      b * p.st[kQ][0] + h * p.st[kQ][2] +
                                      m0 * qs,
                  qs, nq, tid);
    load_tile<HD>(sdo + buf * kSz, static_cast<const bf16*>(p.o) +
                                       b * p.st[kO][0] + h * p.st[kO][2] +
                                       m0 * os,
                  os, nq, tid);
    const long long row0 = (static_cast<long long>(b) * p.h + h) * p.sq + m0;
    load_row(slse + buf * kTile, p.lse + row0, nq, tid);
    load_row(sd + buf * kTile, p.rows + row0, nq, tid);
  };

  load_tile<HD>(sk, static_cast<const bf16*>(p.k) + b * p.st[kK][0] +
                        kh * p.st[kK][2] + n0 * p.st[kK][1],
                p.st[kK][1], nk, tid);
  load_tile<HD>(sv, static_cast<const bf16*>(p.v) + b * p.st[kV][0] +
                        kh * p.st[kV][2] + n0 * p.st[kV][1],
                p.st[kV][1], nk, tid);
  issue(0, 0);
  cp_commit();
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (it == 0) {
      load_a<HD>(ka, sk, w, lane);
      load_a<HD>(va, sv, w, lane);
    }
    const int buf = it & 1, m0 = (it % nqb) * kTile;
    const float* lse = slse + buf * kTile;
    const float* dd = sd + buf * kTile;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mm_abt<HD>(s, ka, sq + buf * kSz, lane);      // S^T = K Q^T
    mm_abt<HD>(dp, va, sdo + buf * kSz, lane);    // dP^T = V dO^T
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col_of(c, e, lane);
        s[c][e] = m0 + col < p.sq
                      ? __expf(rnd(s[c][e]) * p.scale - lse[col])
                      : 0.f;
        dp[c][e] = s[c][e] * (rnd(dp[c][e]) - dd[col]) * p.scale;
      }
    uint32_t a[4][4];
    to_a(a, s);
    mm_ab<HD>(dv, a, sdo + buf * kSz, lane);      // dV += P^T dO
    to_a(a, dp);
    mm_ab<HD>(dk, a, sq + buf * kSz, lane);       // dK += dS^T Q
    __syncthreads();
  }

  store_rows<HD>(static_cast<bf16*>(p.dk) + b * p.st[kDKV][0] +
                     kh * p.st[kDKV][2] + n0 * p.st[kDKV][1],
                 p.st[kDKV][1], dk, w, lane, nk);
  store_rows<HD>(static_cast<bf16*>(p.dv) + b * p.st[kDKV][0] +
                     kh * p.st[kDKV][2] + n0 * p.st[kDKV][1],
                 p.st[kDKV][1], dv, w, lane, nk);
}

// ---------------------------------------------------------------------------
// float32: the same three kernels on the CUDA cores, one thread a row
// ---------------------------------------------------------------------------

// rows [r0, r0 + n) of an (S, hd) f32 view (row stride rs) -> s[kF32Tile][HD]
template <int HD>
__device__ __forceinline__ void f32_tile(float (*s)[HD], const float* g,
                                         long long rs, int n) {
  for (int i = threadIdx.x; i < kF32Tile * HD; i += kF32Rows) {
    const int r = i / HD, c = i % HD;
    s[r][c] = r < n ? g[r * rs + c] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot(const float (&x)[HD], const float* y) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s += x[d] * y[d];
  return s;
}

template <int HD>
__global__ void __launch_bounds__(kF32Rows) attn_fwd_f32(const Params p) {
  __shared__ float sk[kF32Tile][HD], sv[kF32Tile][HD];
  const int bh = blockIdx.x, b = bh / p.h, h = bh % p.h, kh = h / p.g;
  const int row = blockIdx.y * kF32Rows + threadIdx.x;
  const bool live = row < p.sq;
  const float* q = static_cast<const float*>(p.q) + b * p.st[kQ][0] +
                   h * p.st[kQ][2] + min(row, p.sq - 1) * p.st[kQ][1];
  const float* k = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                   kh * p.st[kK][2];
  const float* v = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                   kh * p.st[kV][2];
  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = q[d];
  float m = -INFINITY, l = 0.f;
  for (int n0 = 0; n0 < p.sk; n0 += kF32Tile) {
    const int n = min(kF32Tile, p.sk - n0);
    __syncthreads();
    f32_tile<HD>(sk, k + n0 * p.st[kK][1], p.st[kK][1], n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float s = dot<HD>(qr, sk[j]) * p.scale, mn = fmaxf(m, s);
      l = l * __expf(m - mn) + __expf(s - mn);
      m = mn;
    }
  }
  const float inv = 1.f / l;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int n0 = 0; n0 < p.sk; n0 += kF32Tile) {
    const int n = min(kF32Tile, p.sk - n0);
    __syncthreads();
    f32_tile<HD>(sk, k + n0 * p.st[kK][1], p.st[kK][1], n);
    f32_tile<HD>(sv, v + n0 * p.st[kV][1], p.st[kV][1], n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float pr = __expf(dot<HD>(qr, sk[j]) * p.scale - m) * inv;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += pr * sv[j][d];
    }
  }
  if (!live) return;
  float* o = static_cast<float*>(p.out) + b * p.st[kO][0] + h * p.st[kO][2] +
             row * p.st[kO][1];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = acc[d];
  p.lse[static_cast<long long>(bh) * p.sq + row] = m + logf(l);
}

template <int HD>
__global__ void __launch_bounds__(kF32Rows) attn_bwd_dq_f32(const Params p) {
  __shared__ float sk[kF32Tile][HD], sv[kF32Tile][HD];
  const int bh = blockIdx.x, b = bh / p.h, h = bh % p.h, kh = h / p.g;
  const int row = blockIdx.y * kF32Rows + threadIdx.x;
  const bool live = row < p.sq;
  const int rr = min(row, p.sq - 1);
  const float* q = static_cast<const float*>(p.q) + b * p.st[kQ][0] +
                   h * p.st[kQ][2] + rr * p.st[kQ][1];
  const float* go = static_cast<const float*>(p.o) + b * p.st[kO][0] +
                    h * p.st[kO][2] + rr * p.st[kO][1];
  const float* k = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                   kh * p.st[kK][2];
  const float* v = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                   kh * p.st[kV][2];
  float qr[HD], dor[HD], dq[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = q[d];
    dor[d] = go[d];
    dq[d] = 0.f;
  }
  const long long at = static_cast<long long>(bh) * p.sq + rr;
  const float lse = p.lse[at];
  float dsum = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < p.sk; n0 += kF32Tile) {
      const int n = min(kF32Tile, p.sk - n0);
      __syncthreads();
      f32_tile<HD>(sk, k + n0 * p.st[kK][1], p.st[kK][1], n);
      f32_tile<HD>(sv, v + n0 * p.st[kV][1], p.st[kV][1], n);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float pr = __expf(dot<HD>(qr, sk[j]) * p.scale - lse);
        const float dp = dot<HD>(dor, sv[j]);
        if (pass == 0) {
          dsum += pr * dp;
        } else {
          const float ds = pr * (dp - dsum) * p.scale;
#pragma unroll
          for (int d = 0; d < HD; ++d) dq[d] += ds * sk[j][d];
        }
      }
    }
  }
  if (!live) return;
  p.rows[at] = dsum;
  float* out = static_cast<float*>(p.out) + b * p.st[kDQ][0] +
               h * p.st[kDQ][2] + row * p.st[kDQ][1];
#pragma unroll
  for (int d = 0; d < HD; ++d) out[d] = dq[d];
}

template <int HD>
__global__ void __launch_bounds__(kF32Rows) attn_bwd_dkdv_f32(const Params p) {
  __shared__ float sq[kF32Tile][HD], sdo[kF32Tile][HD];
  __shared__ float slse[kF32Tile], sd[kF32Tile];
  const int bkh = blockIdx.x, b = bkh / p.kvh, kh = bkh % p.kvh;
  const int row = blockIdx.y * kF32Rows + threadIdx.x;
  const bool live = row < p.sk;
  const int rr = min(row, p.sk - 1);
  const float* k = static_cast<const float*>(p.k) + b * p.st[kK][0] +
                   kh * p.st[kK][2] + rr * p.st[kK][1];
  const float* v = static_cast<const float*>(p.v) + b * p.st[kV][0] +
                   kh * p.st[kV][2] + rr * p.st[kV][1];
  float kr[HD], vr[HD], dk[HD], dv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] = k[d];
    vr[d] = v[d];
    dk[d] = dv[d] = 0.f;
  }
  for (int g = 0; g < p.g; ++g) {
    const int h = kh * p.g + g;
    const float* q = static_cast<const float*>(p.q) + b * p.st[kQ][0] +
                     h * p.st[kQ][2];
    const float* go = static_cast<const float*>(p.o) + b * p.st[kO][0] +
                      h * p.st[kO][2];
    const long long row0 = (static_cast<long long>(b) * p.h + h) * p.sq;
    for (int m0 = 0; m0 < p.sq; m0 += kF32Tile) {
      const int n = min(kF32Tile, p.sq - m0);
      __syncthreads();
      f32_tile<HD>(sq, q + m0 * p.st[kQ][1], p.st[kQ][1], n);
      f32_tile<HD>(sdo, go + m0 * p.st[kO][1], p.st[kO][1], n);
      if (threadIdx.x < n) {
        slse[threadIdx.x] = p.lse[row0 + m0 + threadIdx.x];
        sd[threadIdx.x] = p.rows[row0 + m0 + threadIdx.x];
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float pr = __expf(dot<HD>(kr, sq[i]) * p.scale - slse[i]);
        const float ds = pr * (dot<HD>(vr, sdo[i]) - sd[i]) * p.scale;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] += pr * sdo[i][d];
          dk[d] += ds * sq[i][d];
        }
      }
    }
  }
  if (!live) return;
  float* ok = static_cast<float*>(p.dk) + b * p.st[kDKV][0] +
              kh * p.st[kDKV][2] + row * p.st[kDKV][1];
  float* ov = static_cast<float*>(p.dv) + b * p.st[kDKV][0] +
              kh * p.st[kDKV][2] + row * p.st[kDKV][1];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    ok[d] = dk[d];
    ov[d] = dv[d];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// a kernel's opt-in above 48 KB of shared memory, set once a device
template <void (*Kernel)(Params)>
int launch(dim3 grid, int threads, size_t smem, const Params& p,
           cudaStream_t s) {
  static unsigned long long opted_in = 0;   // a bit a device
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64 || !(opted_in >> dev & 1ull)) {
      e = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 64) opted_in |= 1ull << dev;
    }
  }
  Kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// tiles of kTile rows of bf16 in a kernel's shared memory
template <int HD>
constexpr size_t tiles(int n) {
  return static_cast<size_t>(n) * kTile * (HD + 8) * sizeof(bf16);
}

template <int HD>
int fwd(const Params& p, bool f32, cudaStream_t s) {
  if (f32)
    return launch<attn_fwd_f32<HD>>(dim3(p.b * p.h, cdiv(p.sq, kF32Rows)),
                                    kF32Rows, 0, p, s);
  return launch<attn_fwd<HD>>(dim3(cdiv(p.sq, kTile), p.b * p.h), kThreads,
                              tiles<HD>(5), p, s);
}

template <int HD>
int bwd(const Params& p, bool f32, cudaStream_t s) {
  int e;
  if (f32) {
    e = launch<attn_bwd_dq_f32<HD>>(dim3(p.b * p.h, cdiv(p.sq, kF32Rows)),
                                    kF32Rows, 0, p, s);
    if (e) return e;
    return launch<attn_bwd_dkdv_f32<HD>>(
        dim3(p.b * p.kvh, cdiv(p.sk, kF32Rows)), kF32Rows, 0, p, s);
  }
  e = launch<attn_bwd_dq<HD>>(dim3(cdiv(p.sq, kTile), p.b * p.h), kThreads,
                              tiles<HD>(6), p, s);
  if (e) return e;
  return launch<attn_bwd_dkdv<HD>>(dim3(cdiv(p.sk, kTile), p.b * p.kvh),
                                   kThreads,
                                   tiles<HD>(6) + 4 * kTile * sizeof(float),
                                   p, s);
}

template <bool Backward>
int dispatch(const Params& p, int dtype, int hd, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p.b * p.h == 0 || p.sq == 0) return 0;
  if (p.sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == 0;
  switch (hd) {
    case 32: return Backward ? bwd<32>(p, f32, s) : fwd<32>(p, f32, s);
    case 64: return Backward ? bwd<64>(p, f32, s) : fwd<64>(p, f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make(const void* q, const void* k, const void* v, const void* o,
            int b, int h, int kvh, int sq, int sk, const long long* st,
            int n_st, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < n_st; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = st[3 * i + j];
  p.b = b;
  p.h = h;
  p.kvh = kvh;
  p.g = kvh ? h / kvh : 1;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k, v (B, Sk, KV, hd) of dtype code 0 = f32, 1 = bf16
// -> o like q, lse (B, H, Sq) f32. strides: 12 (q, k, v, o; each batch,
// seq, head, in elements), a host array.
int ltp_attn_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int dtype, int hd, int b, int h, int kvh, int sq,
                 int sk, const long long* strides, float scale,
                 void* stream) {
  Params p = make(q, k, v, nullptr, b, h, kvh, sq, sk, strides, 4, scale);
  p.out = o;
  p.lse = static_cast<float*>(lse);
  return dispatch<false>(p, dtype, hd, static_cast<cudaStream_t>(stream));
}

// the backward: q, k, v, the forward's lse, dO (like q) -> dq like q, dk and
// dv like k (one layout); rows (B, H, Sq) f32 the scratch for D. strides: 18
// (q, k, v, dO, dq, dk and dv).
int ltp_attn_bwd(const void* q, const void* k, const void* v,
                 const void* lse, const void* dout, void* rows, void* dq,
                 void* dk, void* dv, int dtype, int hd, int b, int h, int kvh,
                 int sq, int sk, const long long* strides, float scale,
                 void* stream) {
  Params p = make(q, k, v, dout, b, h, kvh, sq, sk, strides, 6, scale);
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.rows = static_cast<float*>(rows);
  return dispatch<true>(p, dtype, hd, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
