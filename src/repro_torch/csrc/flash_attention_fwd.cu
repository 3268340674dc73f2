// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// softcapped grouped-query attention with an online softmax.  q and k have
// head dim D, v and the output their own, Dv (MLA: D = 192, Dv = 128).
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py (:26 / :86, `pallas_call` at
// :106).  It computes the same function with the same cast points: logits
// are q.k^T in float32 times `scale`, then the optional tanh softcap; the
// running max m, the denominator l and the accumulator are float32; p is
// added into l in float32, then rounded to v's dtype before p.v; the
// output is acc / max(l, 1e-30) in q's dtype.
//
// Two variants compute it.  The host picks one from the inputs alone
// (repro_torch/kernels/flash_attention/ops.py, `variant`):
// `fa_mma_bf16_kernel<D, DV>` (bf16 tensor cores) for bf16 q, k, v, o and
// 16-byte aligned pointers and row strides, which is every served and
// trained path; `fa_fwd_kernel<T, D, DV>` (SIMT) for everything else, every
// float32 call included.  Both are built for the (D, Dv) pairs of
// FA_PAIRS below, which `HEAD_DIM_PAIRS` of ops.py repeats (a CPU test
// holds the two equal): (32, 32), (64, 64), (128, 128), (256, 256),
// (192, 128) and (48, 32).  Both share the grid: one thread block owns one
// (batch, head, 64-row q tile) and loops over the 64-row K/V tiles itself,
// keeping m, l and the accumulator in registers.
// The TPU walks the kv blocks as a sequential grid axis that carries
// (acc, m, l) in VMEM scratch; here blocks run in parallel in no order.
// Query head h reads KV head h / (H / KH): no broadcast copy of K/V.  Tiles
// whose every (q, k) pair is masked by causality or the window are never
// loaded.  Unlike the TPU kernel both mask ragged tails, so any S >= 1
// works.
//
// What bounds it.  At the serving path's shapes (B=1, H=4, KH=1, D=256,
// S=511, causal, bf16) the function moves ~2.6 MB (0.78 us at 3.35 TB/s)
// and does ~0.54 GFLOP (0.54 us on the bf16 tensor cores), so the card's
// bound is memory, at under a microsecond (recurrentgemma-9b, H=16: 2.66
// us; the training forward, B=2, S=512: 1.57 us; granite-moe-1b-a400m,
// H=16, KH=8, D=64: 0.94 us).  Neither variant comes near it: the grid has
// only B*H*ceil(S/64) = 32 to 128 blocks for 132 SMs, and the last q tile
// walks 8 kv tiles in a serial chain.
//
// The SIMT variant (`fa_fwd_kernel`, 256 threads).  Tiles are staged in
// shared memory as float32 with one float of row padding (no bank
// conflicts on the strided reads); at D = Dv = 256 that is 214,016 bytes
// of dynamic shared memory, at (192, 128) 148,480.  Its products are
// scalar float32 FMAs: per kv tile at D = 256 a block issues ~50k
// shared-memory load instructions (p.v reads one float of V per FMA,
// q.k^T half a float), ~28 us at one warp-wide load a cycle.
// So, estimated from the code and not read from a counter, what bounds it
// is shared-memory load issue in each block's serial chain: it took
// 0.26 ms at S=511, D=256 whether H was 4 or 16 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
//
// The tensor-core variant (`fa_mma_bf16_kernel`, 4 warps).  What it does
// about that chain:
// * Products.  q.k^T and p.v are `mma.sync.m16n8k16` with bf16 operands and
//   float32 accumulators.  bf16 q and k widen to float32 exactly, so q.k^T
//   forms the reference's products; only the order of the float32 sums
//   differs.  Each warp owns 16 query rows: its 16 x 64 logit tile stays in
//   the accumulators, the online softmax runs on them (each lane holds 2
//   rows, reduced across the 4 lanes of a quad with shuffles), and p, added
//   into l in float32, is rounded to bf16 straight into the A operand of
//   p.v, in registers.  The output accumulator is Dv / 2 floats a thread
//   (128 at Dv = 256, 64 at MLA's Dv = 128).
// * Loads.  Q, K and V stay bf16 in shared memory, in rows of 16-byte
//   chunks XOR-swizzled by the row (padded by one chunk at D = 32), so
//   `ldmatrix` reads them without bank conflicts; V is read transposed by
//   `ldmatrix.trans`.  K/V tiles are double-buffered: `cp.async` fetches
//   tile kt + 1 while tile kt is computed, and rows past S are zero-filled.
//   Q and K tiles are D wide, V tiles Dv wide: at D = Dv = 256 that is 5
//   tiles of 64 x 256 x 2 B = 163,840 B of dynamic shared memory, one
//   block an SM; at (192, 128) 106,496 B.
// * Why `mma.sync` and not `wgmma` with TMA: the call's 0.54 GFLOP take
//   0.55 us at the bf16 peak, so what sets the time is one block's serial
//   chain of up to 8 kv tiles and the grid's fill, not the tensor-core
//   rate.
// Measured (chip_smoke.py phase 3, profiler device time, NVIDIA H100 80GB
// HBM3 at 700 W): at S = 511, D = 256, 0.035 ms at H = 4 and at H = 16
// (SDPA 0.08-0.15 ms, the SIMT variant 0.26 ms), 0.036 ms for the training
// forward (B = 2, S = 512); at granite's D = 64, 0.014 ms (SIMT 0.080).
// 254 registers at D = 256, no spills.  The time grows with the chain,
// ~3.5 us a kv tile at D = 256 after ~6 us of set-up, and not with H: the
// blocks' serial kv walk bounds it, so splitting the kv loop across blocks
// or warps comes before `wgmma`.
//
// Layout.  Each of q, k, v, o is indexed (b, h, s, d) through its own
// element strides for b, h and s; d must be unit-stride.  So the model's
// (B, S, H, D) tensors go in as transposed views, with no copy, and the
// output is written straight into a (B, S, H, Dv) buffer.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd (SIMT) and
// flash_attention_fwd_mma (tensor cores, bf16 only) return 0, a
// cudaError_t, or -1 for arguments they do not take (a (D, Dv) pair
// outside FA_PAIRS among them); each raises its
// kernel's dynamic shared-memory limit before every launch (both are above
// the 48 KB static limit at D = 256).  flash_attention_fwd_mma_smem_bytes
// gives the shared memory the tensor-core kernel asks for.  They allocate
// nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 micro-tiles of 4 x 4 logits

// the (D, Dv) pairs both variants are built for: q/k head dim, v head dim
#define FA_PAIRS(X) \
  X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(192, 128) X(48, 32)

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

template <int D, int DV>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * (DV + 1) + BQ * (BK + 1)) *
         static_cast<int>(sizeof(float));
}

// rows r0 .. r0 + ROWS - 1 of a (S, W) matrix (row stride rs, unit-stride
// columns) into a float32 tile of row stride W + 1; rows past S are
// zero-filled.  Where W divides THREADS (every equal-width pair, and Dv),
// a thread copies one column of every (THREADS / W)-th row, walking a
// pointer down the rows (one add a row, whatever the strides); else (q/k
// at 192 or 48) the block's threads walk the tile's ROWS x W elements
// with a stride of THREADS
template <int ROWS, int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int S) {
  if constexpr (THREADS % W == 0) {
    constexpr int STEP = THREADS / W;
    const int c = threadIdx.x % W, r = threadIdx.x / W;
    const T* p = src + static_cast<long long>(r0 + r) * rs + c;
    for (int rr = r; rr < ROWS; rr += STEP, p += STEP * rs)
      dst[rr * (W + 1) + c] = r0 + rr < S ? to_f(*p) : 0.f;
  } else {
    for (int e = threadIdx.x; e < ROWS * W; e += THREADS) {
      const int r = e / W, c = e % W;
      dst[r * (W + 1) + c] =
          r0 + r < S ? to_f(src[static_cast<long long>(r0 + r) * rs + c])
                     : 0.f;
    }
  }
}

// the K tile (D wide) and the V tile (Dv wide) of kv rows k0 .. k0 + 63;
// at equal widths that divide THREADS one pointer walk loads both, two
// loads in flight a step: two load_tile calls, at the same registers,
// took 11-14 % more device time at D = 256 and D = 64 (chip_smoke.py
// phase 3, NVIDIA H100 80GB HBM3 at 700 W)
template <int D, int DV, typename T>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const T* kb,
                                        long long ks, const T* vb,
                                        long long vs, int k0, int S) {
  if constexpr (D == DV && THREADS % D == 0) {
    constexpr int STEP = THREADS / D;
    const int c = threadIdx.x % D, r = threadIdx.x / D;
    const T* kp = kb + static_cast<long long>(k0 + r) * ks + c;
    const T* vp = vb + static_cast<long long>(k0 + r) * vs + c;
    for (int rr = r; rr < BK; rr += STEP, kp += STEP * ks, vp += STEP * vs) {
      const bool in = k0 + rr < S;
      Ks[rr * (D + 1) + c] = in ? to_f(*kp) : 0.f;
      Vs[rr * (D + 1) + c] = in ? to_f(*vp) : 0.f;
    }
  } else {
    load_tile<BK, D>(Ks, kb, ks, k0, S);
    load_tile<BK, DV>(Vs, vb, vs, k0, S);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides qs,
              Strides ks, Strides vs, Strides os, int H, int KH, int S,
              float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;    // padded row stride of the Q/K tiles
  constexpr int DVP = DV + 1;  // padded row stride of the V tile
  constexpr int SP = BK + 1;   // padded row stride of the logit tile
  constexpr int DJ = DV / 4;   // accumulator columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DVP;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KH;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  // the Q tile stays in shared memory for the whole kv loop
  load_tile<BQ, D>(Qs, qb, qs.s, q0, S);

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
    load_kv<D, DV>(Ks, Vs, kb, ks.s, vb, vs.s, k0, S);
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
      const float* vrow = Vs + kk * DVP + part;
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

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int H, int KH, int S, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, D, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], H, KH, S, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Strides* st, int B, int H, int KH, int S, int D, int Dv,
             float scale, int causal, int window, float softcap,
             cudaStream_t stream) {
#define FA_CASE(d, dv)                                                    \
  if (D == d && Dv == dv)                                                 \
    return launch<T, d, dv>(q, k, v, o, st, B, H, KH, S, scale, causal,   \
                            window, softcap, stream);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}

// ------------------------------------------------- the tensor-core variant
constexpr int MMA_THREADS = 128;  // 4 warps of 16 query rows
constexpr int NKT = BK / 8;       // n8 tiles of a warp's 16 x 64 logits
static_assert(BQ == 16 * (MMA_THREADS / 32), "a warp owns 16 query rows");
static_assert(BQ == BK, "Q, K and V tiles have 64 rows");

// dynamic shared memory of one block: the Q tile and two buffers of a K
// tile (D wide) and a V tile (Dv wide)
int mma_smem_bytes(int D, int Dv) {
  return (3 * tile_of(D).rsc + 2 * tile_of(Dv).rsc) * BQ * 16;
}

// rows r0..r0+63 of a (S, 8 NCH) matrix with row stride rs into a tile, one
// 16-byte cp.async a chunk; rows past S are zero-filled
template <int NCH>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, Tile t,
                                      const __nv_bfloat16* src, long long rs,
                                      int r0, int S) {
  for (int c = threadIdx.x; c < BQ * NCH; c += MMA_THREADS) {
    const int r = c / NCH, ch = c % NCH;
    __nv_bfloat16* d = dst + toff(t, r, 8 * ch);
    if (r0 + r < S)
      cp_async16(d, src + static_cast<long long>(r0 + r) * rs + 8 * ch);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 1)
fa_mma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                   Strides vs, Strides os, int H, int KH, int S, float scale,
                   int causal, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CH = D / 8;    // 16-byte chunks of a Q/K row
  constexpr int CHV = DV / 8;  // 16-byte chunks of a V row; n8 tiles of o
  const Tile tt = tile_of(D), tv = tile_of(DV);
  const int k_elems = BQ * tt.rsc * 8, v_elems = BK * tv.rsc * 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // buffer j: K at KV + j (k_elems + v_elems), its V k_elems after it
  __nv_bfloat16* KV = Qs + k_elems;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KH;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;

  // live kv tiles: [kt_lo, kt_hi]
  int kt_lo = 0;
  if (window > 0) {
    const int kmin = q0 - window + 1;  // first key row q0 may see
    kt_lo = kmin > 0 ? kmin / BK : 0;
  }
  const int last_q = min(q0 + BQ - 1, S - 1);
  const int kt_hi = (causal ? last_q : S - 1) / BK;

  stage<CH>(Qs, tt, qb, qs.s, q0, S);
  stage<CH>(KV, tt, kb, ks.s, kt_lo * BK, S);
  stage<CHV>(KV + k_elems, tv, vb, vs.s, kt_lo * BK, S);
  cp_async_commit();

  // ldmatrix row addresses: an A operand (or a B operand read through
  // .trans) takes rows by lane bit 3 and columns by bit 4; a B operand
  // read as stored takes rows by bit 4 and columns by bit 3
  const int lr_a = (lane & 7) + ((lane >> 3) & 1) * 8, lc_a = (lane >> 4) * 8;
  const int lr_b = (lane & 7) + (lane >> 4) * 8, lc_b = ((lane >> 3) & 1) * 8;
  const int row0 = 16 * warp;            // the warp's rows in the q tile
  const int qa = q0 + row0 + gr;         // this lane's rows: qa and qa + 8
  const uint32_t q_base = smem_u32(Qs);

  float acc[CHV][4];  // o: rows qa, qa + 8; columns 8j + 2qd and the next
#pragma unroll
  for (int j = 0; j < CHV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // finite: a masked logit is -inf
  float l[2] = {0.f, 0.f};        // this lane's part of the row sums

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      __nv_bfloat16* nxt = KV + (buf ^ 1) * (k_elems + v_elems);
      stage<CH>(nxt, tt, kb, ks.s, (kt + 1) * BK, S);
      stage<CHV>(nxt + k_elems, tv, vb, vs.s, (kt + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = KV + buf * (k_elems + v_elems);
    const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Ks + k_elems);
    const int k0 = kt * BK;

    // s = q.k^T: this warp's 16 rows x 64 keys, NKT n8 tiles
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_base + 2 * toff(tt, row0 + lr_a, 16 * kd + lc_a));
#pragma unroll
      for (int kn = 0; kn < NKT / 2; ++kn) {  // keys 16 kn .. 16 kn + 15
        uint32_t bf[4];
        ldsm_x4(bf, k_base + 2 * toff(tt, 16 * kn + lr_b, 16 * kd + lc_b));
        mma16816(s[2 * kn], a, bf[0], bf[1]);
        mma16816(s[2 * kn + 1], a, bf[2], bf[3]);
      }
    }

    // scale, softcap and mask; element e of tile j is row qa + 8 (e >> 1),
    // key k0 + 8 j + 2 qd + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qa + 8 * (e >> 1);
        const int kp = k0 + 8 * j + 2 * qd + (e & 1);
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[j][e] = ok ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }

    // online softmax on the fragments: a row's 4 lanes are a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);  // masked: exp(-inf) = 0
        rs[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < CHV; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p.v: the logit tiles 2 kk and 2 kk + 1, rounded to bf16, are the
    // A operand of keys 16 kk .. 16 kk + 15; V is read transposed
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      uint32_t a[4];
      a[0] = bits(__floats2bfloat162_rn(s[2 * kk][0], s[2 * kk][1]));
      a[1] = bits(__floats2bfloat162_rn(s[2 * kk][2], s[2 * kk][3]));
      a[2] = bits(__floats2bfloat162_rn(s[2 * kk + 1][0], s[2 * kk + 1][1]));
      a[3] = bits(__floats2bfloat162_rn(s[2 * kk + 1][2], s[2 * kk + 1][3]));
#pragma unroll
      for (int dn = 0; dn < DV / 16; ++dn) {  // columns 16 dn .. 16 dn + 15
        uint32_t bv[4];
        ldsm_x4_t(bv, v_base + 2 * toff(tv, 16 * kk + lr_a, 16 * dn + lc_a));
        mma16816(acc[2 * dn], a, bv[0], bv[1]);
        mma16816(acc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lm = fmaxf(lt, 1e-30f);
    const int qp = qa + 8 * r;
    if (qp < S) {
      __nv_bfloat16* orow = o + b * os.b + h * os.h +
                            static_cast<long long>(qp) * os.s + 2 * qd;
#pragma unroll
      for (int j = 0; j < CHV; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * r] / lm,
                                  acc[j][2 * r + 1] / lm);
    }
  }
}

template <int D, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const Strides* st, int B, int H, int KH, int S, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  const int smem = mma_smem_bytes(D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      fa_mma_bf16_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_mma_bf16_kernel<D, DV><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], H, KH, S, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// q: (B, H, S, D); k: (B, KH, S, D); v: (B, KH, S, Dv); o: (B, H, S, Dv);
// all of one dtype (0: float32, 1: bfloat16), indexed through `strides`:
// 12 element strides, (b, h, s) of q, k, v and o in that order, with d
// unit-stride.  (D, Dv) must be one of FA_PAIRS.  window <= 0 means none,
// softcap <= 0 means none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int KH, int S, int D, int Dv, float scale,
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
    return dispatch<float>(q, k, v, o, st, B, H, KH, S, D, Dv, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, B, H, KH, S, D, Dv, scale,
                                   causal, window, softcap, s);
  return -1;
}

// The tensor-core variant: the arguments of flash_attention_fwd, bf16 only
// (no dtype).  It takes the (D, Dv) pairs of FA_PAIRS and, for its 16-byte
// cp.async row loads, 16-byte aligned pointers and (b, h, s) strides of
// q, k, v and o; else it returns -1.
extern "C" int flash_attention_fwd_mma(const void* q, const void* k,
                                       const void* v, void* o,
                                       const long long* strides, int B, int H,
                                       int KH, int S, int D, int Dv,
                                       float scale, int causal, int window,
                                       float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH != 0 || H > 65535 ||
      B > 65535 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return -1;
  Strides st[4];
  for (int t = 0; t < 4; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
    if (st[t].b % 8 != 0 || st[t].h % 8 != 0 || st[t].s % 8 != 0) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_CASE(d, dv)                                                     \
  if (D == d && Dv == dv)                                                  \
    return launch_mma<d, dv>(q, k, v, o, st, B, H, KH, S, scale, causal,   \
                             window, softcap, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}

extern "C" int flash_attention_fwd_mma_smem_bytes(int D, int Dv) {
  return mma_smem_bytes(D, Dv);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
