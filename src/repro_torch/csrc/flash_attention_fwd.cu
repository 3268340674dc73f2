// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// softcapped grouped-query attention with an online softmax.
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py.  It computes the same
// function with the same cast points: logits are q.k^T in float32 times
// `scale`, then the optional tanh softcap; the running max m, the
// denominator l and the accumulator are float32; p is rounded to v's dtype
// before p.v; the output is acc / max(l, 1e-30) in q's dtype.
//
// Design for this card.  The TPU walks the kv blocks as a sequential grid
// axis that carries (acc, m, l) in VMEM scratch; here blocks run in
// parallel in no order, so one thread block owns one (batch, head, 64-row
// q tile) and loops over the 64-row K/V tiles itself, keeping m and l in
// registers and the accumulator in registers (D/4 floats per thread).
// Query head h reads KV head h / (H / KH): no broadcast copy of K/V.  Tiles
// whose every (q, k) pair is masked by causality or the window are never
// loaded.  Unlike the TPU kernel it masks ragged tails, so any S >= 1
// works, for D in {32, 64, 128, 256}.  Tiles are staged in shared memory as
// float32 with one float of row padding (no bank conflicts on the strided
// reads); at D = 256 that is 214,016 bytes of dynamic shared memory, above
// the 48 KB static limit, so every launch raises the function's limit first.
//
// What bounds it.  At the serving path's shapes (B=1, H=4, KH=1, D=256,
// S=512, causal, bf16) the function moves ~2.6 MB (0.78 us at 3.35 TB/s)
// and does ~0.54 GFLOP (0.54 us on the bf16 tensor cores), so the card's
// bound is memory, at under a microsecond.  This kernel is far from it
// (0.26-0.28 ms measured on an H100 by chip_smoke.py): the path's shapes
// give only B*H*ceil(S/64) = 32 blocks for 132 SMs, the last q tile walks
// 8 kv tiles, and per kv tile a block issues ~50k shared-memory load
// instructions for its scalar float32 FMAs (p.v reads one float of V per
// FMA, q.k^T half a float), ~28 us at one warp-wide load a cycle.  So,
// estimated from the code and not read from a counter, what bounds it is
// shared-memory load issue on a quarter of the SMs, not HBM and not
// arithmetic.  Tensor cores (mma.sync, then wgmma with TMA), wide
// shared-memory loads and splitting the kv loop across blocks are the
// later steps; this version is the simple one that is right.
//
// Layout.  Each of q, k, v, o is indexed (b, h, s, d) through its own
// element strides for b, h and s; d must be unit-stride.  So the model's
// (B, S, H, D) tensors go in as transposed views, with no copy, and the
// output is written straight into a (B, S, H, D) buffer.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd returns 0, a
// cudaError_t, or -1 for arguments it does not take.  It allocates nothing
// and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 micro-tiles of 4 x 4 logits

// element strides of the b, h and s axes of one tensor
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides qs,
              Strides ks, Strides vs, Strides os, int H, int KH, int S,
              float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;   // padded row stride of the Q/K/V tiles
  constexpr int SP = BK + 1;  // padded row stride of the logit tile
  constexpr int DJ = D / 4;   // accumulator columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KH;
  const long long qbase = b * qs.b + h * qs.h + q0 * qs.s;
  const long long kbase = b * ks.b + (h / group) * ks.h;
  const long long vbase = b * vs.b + (h / group) * vs.h;

  // tile loads: a thread copies column lc of every RSTEP-th row, walking a
  // pointer down the rows (one add a row, whatever the strides)
  static_assert(THREADS % D == 0, "a row's columns split across threads");
  constexpr int RSTEP = THREADS / D;
  const int lc = tid % D, lr = tid / D;

  // the Q tile stays in shared memory for the whole kv loop
  {
    const T* src = q + qbase + lr * qs.s + lc;
    for (int rr = lr; rr < BQ; rr += RSTEP, src += RSTEP * qs.s)
      Qs[rr * DP + lc] = (q0 + rr < S) ? to_f(*src) : 0.f;
  }

  // live kv tiles: [kt_lo, kt_hi]
  int kt_lo = 0;
  if (window > 0) {
    const int kmin = q0 - window + 1;  // first key row q0 may see
    kt_lo = kmin > 0 ? kmin / BK : 0;
  }
  const int last_q = min(q0 + BQ - 1, S - 1);
  const int kt_hi = (causal ? last_q : S - 1) / BK;

  // logit micro-tile: rows ty*4 + i, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  // softmax and p.v: row r, columns part + 4*j
  const int r = tid / 4, part = tid % 4;
  float m = -1e30f, l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's p.v has finished reading Ks/Vs/Ps
    const T* ksrc = k + kbase + (k0 + lr) * ks.s + lc;
    const T* vsrc = v + vbase + (k0 + lr) * vs.s + lc;
    for (int rr = lr; rr < BK;
         rr += RSTEP, ksrc += RSTEP * ks.s, vsrc += RSTEP * vs.s) {
      const bool in = k0 + rr < S;
      Ks[rr * DP + lc] = in ? to_f(*ksrc) : 0.f;
      Vs[rr * DP + lc] = in ? to_f(*vsrc) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = ty * 4 + i, c = tx + 16 * j;
        const int qp = q0 + rr, kp = k0 + c;
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        Ps[rr * SP + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: the 4 threads of a row are 4 neighbouring lanes
    float mx = -INFINITY;
    for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ps[r * SP + c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = part; c < BK; c += 4) {
      const float p = expf(Ps[r * SP + c] - m_new);  // masked: exp(-inf) = 0
      sum += p;
      Ps[r * SP + c] = to_f(from_f<T>(p));  // p in v's dtype for p.v
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] *= alpha;
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * SP + kk];
      const float* vrow = Vs + kk * DP + part;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[j] = fmaf(p, vrow[4 * j], acc[j]);
    }
  }

  if (q0 + r < S) {
    const float lm = fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + h * os.h + (q0 + r) * os.s + part;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[4 * j] = from_f<T>(acc[j] / lm);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int H, int KH, int S, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], H, KH, S, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Strides* st, int B, int H, int KH, int S, int D,
             float scale, int causal, int window, float softcap,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, B, H, KH, S, scale, causal, window,
                           softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, st, B, H, KH, S, scale, causal, window,
                           softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, st, B, H, KH, S, scale, causal,
                            window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, st, B, H, KH, S, scale, causal,
                            window, softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

// q: (B, H, S, D); k, v: (B, KH, S, D); o: (B, H, S, D); all of one dtype
// (0: float32, 1: bfloat16), indexed through `strides`: 12 element strides,
// (b, h, s) of q, k, v and o in that order, with d unit-stride.  window <= 0
// means none, softcap <= 0 means none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int KH, int S, int D, float scale,
                                   int causal, int window, float softcap,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0 || H > 65535 ||
      B > 65535)
    return -1;
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, st, B, H, KH, S, D, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, B, H, KH, S, D, scale,
                                   causal, window, softcap, s);
  return -1;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
