// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_fwd` of
// src/repro/kernels/ssd/kernel.py.  It computes the same function as the
// plain version (repro_torch/kernels/ssd/ref.py): per (batch, head), over
// chunks of Q steps in order, with A = -exp(a_log[h]) and cum the running
// sum of dt * A inside the chunk,
//
//   y_i = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) c_i . S_prev                          (float32)
//   S   = exp(cum_last) S_prev + sum_j exp(cum_last - cum_j) dt_j b_j x_j^T
//
// with the (N x P) state S carried from chunk to chunk in float32.  The
// causal mask is applied before the exponent (no exp of a positive
// segment sum is ever taken).  Unlike the TPU kernel, it also takes an
// initial state (null means zeros) and writes the final state, which is
// what serving prefill needs, and it masks a ragged tail itself: steps
// t >= T act as dt = 0 and write nothing, exactly as zero padding of the
// softplus output does in the reference.
//
// Two variants compute it.  The host picks one from the inputs alone
// (repro_torch/kernels/ssd/ops.py, `variant`): `ssd_mma_bf16_kernel` for
// bf16 x, b, c with N and P multiples of 16, the chunk a multiple of 32 and
// 16-byte aligned pointers and row strides (the serving path),
// `ssd_fwd_kernel<T>` (SIMT) for everything else, every float32 call
// included.
//
// What bounds it.  At the serving path's shapes (B = 1, H = 32, P = 64,
// G = 1, N = 128, Q = 128, bf16 x, b, c) a prefill of T = 511 moves about
// 8.7 MB (x bf16, y float32, dt, b, c, two states): 0.0026 ms at
// 3.35 TB/s, against 0.0007 ms for its 0.7 GFLOP on bf16 tensor cores,
// so the card's bound is bytes.
//
// The tensor-core variant (`ssd_mma_bf16_kernel`).  The SIMT kernel below
// held four things against that bound; this design answers each:
//
// * Grid.  The SIMT grid is (H, B): 32 blocks at B = 1 on 132 SMs.  The P
//   columns of the state are independent of each other, so here a block
//   owns a tile of PT = 16 of them: grid (P / 16, H, B), 128 blocks at the
//   serving shape.  Each block recomputes c.b^T for its head's group
//   (~4 MFLOP a chunk on tensor cores) and carries its own N x 16 slice of
//   the float32 state, in registers.
// * Occupancy and shared memory.  The SIMT block stages the chunk as
//   float32 (216,704 B).  Here x, b and c stay bf16 in shared memory
//   (157,696 B at N = 128, Q = 128 with both buffers), and no Q x Q tile
//   goes through it: warp w owns rows 16w..16w+15 of the chunk and walks
//   its keys in tiles of 16 up to the diagonal, as flash kernels walk
//   theirs; each 16 x 16 tile of c.b^T stays in the mma accumulators, is
//   decayed and masked there and is fed back as the A operand of att.x.
// * No tensor cores.  All four products are `mma.sync.m16n8k16` bf16 with
//   float32 accumulation; warp w also owns state rows 16w..16w+15 for the
//   update:
//     G = C.B^T (depth N): both operands are bf16 inputs, exact;
//     att_ij = G_ij exp(cum_i - cum_j) dt_j for j <= i, else 0, in float32
//       registers, the mask applied to the exponent (exp(-1e30) = 0, as
//       in the plain version) so no positive segment sum is exponentiated;
//     y = att.X + exp(cum_i) (C.S_prev): att and S_prev are float32, so each
//       enters as hi = bf16(v) and lo = bf16(v - hi), two products summed in
//       float32 (X and C are exact);
//     S = exp(cum_last) S + B^T.(w x), w_j = exp(cum_last - cum_j) dt_j: B^T
//       exact through `ldmatrix.trans`, w x split into hi + lo.
//   No operand that is not a bf16 value enters a product as one bf16
//   value: a single rounding of att, S or w x to bf16 puts y 20-25 times
//   past the 1e-4 * max|y| gate, the split keeps it within 0.05 of it
//   (tests/test_torch_ssd.py emulates both).  The state itself is never
//   stored in bf16: only its hi/lo copy for c.S_prev is.
// * No overlap of loads.  Chunk k + 1's x tile (Q x 16), b, c (Q x N) and
//   dt are fetched with `cp.async` (16 B; 4 B for dt) into the second of two
//   buffers while chunk k is computed.
//
// Shared memory rows of b and c are 16-byte chunks XOR-swizzled by the row
// (N % 64 == 0) or padded by one chunk, so the 8 rows an `ldmatrix` phase
// reads fall in 8 different bank groups.
//
// The SIMT variant (`ssd_fwd_kernel<T>`).  One thread block owns one
// (batch, head) and loops over the chunks itself, keeping the state in
// shared memory (N x P floats).  Each chunk is staged in shared memory as
// float32 (x: Q x P, b and c: Q x N, one float of row padding against
// bank conflicts), then the block computes y in tiles of 32 rows (the
// tile's attention rows, 32 x Q, are staged too, and only keys j below the
// tile's last row are touched), then updates the state.  Every thread owns
// a small register tile of each product with strided rows and columns.
// At N = 128, P = 64, Q = 128 that is 216,704 bytes of dynamic shared
// memory.
//
// Both variants read head h's group h / (H / G) of b and c straight
// through their strides (no repeat of b and c to heads), raise the
// function's dynamic shared-memory limit before every launch (both are
// above the 48 KB static limit), launch on the caller's stream and
// allocate nothing.
//
// Layout.  x (B, T, H, P), dt (B, T, H), b and c (B, T, G, N) and y
// (B, T, H, P) are indexed through their own element strides for the
// batch, step and head (or group) axes; the last axis of x, b, c and y
// must be unit-stride.  So the model's slices of its conv output go in as
// views, with no copy.  a_log (H,), init_state and final_state
// (B, H, N, P) are contiguous float32.  x, b and c are float32 or bf16;
// dt and y are float32.
//
// Plain C interface (loaded with ctypes): ssd_fwd (SIMT) and ssd_fwd_mma
// (tensor cores, bf16 only) return 0, a cudaError_t, or -1 for arguments
// they do not take (init_state may be null, final_state may not).
// ssd_fwd_smem_bytes and ssd_fwd_mma_smem_bytes give the dynamic shared
// memory a launch of those sizes asks for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RT = 32;  // rows of a y tile
constexpr int MAX_Q = 128;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;

// element strides of the batch, step and head (or group) axes
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

int smem_bytes(int N, int P, int Q) {
  const int floats = N * (P + 1) + Q * (P + 1) + 2 * Q * (N + 1) +
                     RT * (Q + 1) + 3 * Q;
  return floats * static_cast<int>(sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ b,
               const T* __restrict__ c, const float* __restrict__ init_state,
               float* __restrict__ y, float* __restrict__ final_state,
               Strides xs, Strides dts, Strides bs, Strides cs, Strides ys,
               int T_len, int H, int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  const int PS = P + 1, NS = N + 1, QS = Q + 1;
  float* S = smem;              // N x PS   state
  float* X = S + N * PS;        // Q x PS   x of the chunk
  float* Bm = X + Q * PS;       // Q x NS   b of the chunk
  float* Cm = Bm + Q * NS;      // Q x NS   c of the chunk
  float* Att = Cm + Q * NS;     // RT x QS  attention rows of a y tile
  float* DT = Att + RT * QS;    // Q        dt
  float* CUM = DT + Q;          // Q        running sum of dt * A
  float* W = CUM + Q;           // Q        exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (H / G);
  const float A = -expf(a_log[h]);

  const T* xb = x + bi * xs.b + h * xs.h;
  const float* dtb = dt + bi * dts.b + h * dts.h;
  const T* bb = b + bi * bs.b + g * bs.h;
  const T* cb = c + bi * cs.b + g * cs.h;
  float* yb = y + bi * ys.b + h * ys.h;
  const long long sbase = (static_cast<long long>(bi) * H + h) * N * P;

  for (int e = tid; e < N * P; e += THREADS)
    S[(e / P) * PS + e % P] = init_state ? init_state[sbase + e] : 0.f;

  const int PG = P / 4;  // column groups: a thread owns p = pg + k * PG
  const int NG = N / 8;  // state row groups: n = ng + a * NG
  const int nc = (T_len + Q - 1) / Q;
  for (int ic = 0; ic < nc; ++ic) {
    const int t0 = ic * Q;
    const int valid = min(Q, T_len - t0);

    // stage the chunk; steps past T are zeros with dt = 0
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e % P;
      X[j * PS + p] =
          j < valid ? to_f(xb[static_cast<long long>(t0 + j) * xs.t + p])
                    : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      const bool ok = j < valid;
      Bm[j * NS + n] =
          ok ? to_f(bb[static_cast<long long>(t0 + j) * bs.t + n]) : 0.f;
      Cm[j * NS + n] =
          ok ? to_f(cb[static_cast<long long>(t0 + j) * cs.t + n]) : 0.f;
    }
    for (int j = tid; j < Q; j += THREADS)
      DT[j] = j < valid ? dtb[static_cast<long long>(t0 + j) * dts.t] : 0.f;
    __syncthreads();

    // running sum of dt * A: warp 0, Q / 32 consecutive steps a lane
    if (tid < 32) {
      const int per = Q / 32;
      float loc[MAX_Q / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k) {
        if (k < per) {
          run += DT[tid * per + k] * A;
          loc[k] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < MAX_Q / 32; ++k)
        if (k < per) CUM[tid * per + k] = excl + loc[k];
    }
    __syncthreads();
    const float cum_last = CUM[Q - 1];
    for (int j = tid; j < Q; j += THREADS)
      W[j] = expf(cum_last - CUM[j]) * DT[j];

    // y, in tiles of RT rows
    for (int i0 = 0; i0 < valid; i0 += RT) {
      const int jmax = i0 + RT;  // keys a row of this tile can see
      const int JG = jmax / 4;   // key groups: a thread owns j = jg + k * JG
      // att_ij = (c_i . b_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
      for (int mt = tid; mt < (RT / 4) * JG; mt += THREADS) {
        const int jg = mt % JG, ig = mt / JG;
        float acc[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            cv[a] = Cm[(i0 + ig + a * (RT / 4)) * NS + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = Bm[(jg + k * JG) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(cv[a], bv[k], acc[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ig + a * (RT / 4), i = i0 + r;
          const float ci = CUM[i];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = jg + k * JG;
            Att[r * QS + j] =
                j <= i ? acc[a][k] * expf(ci - CUM[j]) * DT[j] : 0.f;
          }
        }
      }
      __syncthreads();

      // y_i = sum_{j<=i} att_ij x_j + exp(cum_i) c_i . S_prev
      for (int mt = tid; mt < (RT / 2) * PG; mt += THREADS) {
        const int pg = mt % PG, ig = mt / PG;
        float acc[2][4] = {}, inter[2][4] = {};
#pragma unroll 4
        for (int j = 0; j < jmax; ++j) {
          float av[2], xv[4];
#pragma unroll
          for (int a = 0; a < 2; ++a) av[a] = Att[(ig + a * (RT / 2)) * QS + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = X[j * PS + pg + k * PG];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(av[a], xv[k], acc[a][k]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[2], sv[4];
#pragma unroll
          for (int a = 0; a < 2; ++a)
            cv[a] = Cm[(i0 + ig + a * (RT / 2)) * NS + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) sv[k] = S[n * PS + pg + k * PG];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              inter[a][k] = fmaf(cv[a], sv[k], inter[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = i0 + ig + a * (RT / 2);
          if (i < valid) {
            const float e = expf(CUM[i]);
            float* row = yb + static_cast<long long>(t0 + i) * ys.t;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              row[pg + k * PG] = acc[a][k] + e * inter[a][k];
          }
        }
      }
      __syncthreads();  // the next tile rewrites Att
    }

    // S = exp(cum_last) S_prev + sum_j W_j b_j x_j^T
    const float dec = expf(cum_last);
    for (int mt = tid; mt < NG * PG; mt += THREADS) {
      const int pg = mt % PG, ng = mt / PG;
      float acc[8][4] = {};
#pragma unroll 2
      for (int j = 0; j < valid; ++j) {
        const float wj = W[j];
        float bv[8], xv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) bv[a] = wj * Bm[j * NS + ng + a * NG];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = X[j * PS + pg + k * PG];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(bv[a], xv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* s = &S[(ng + a * NG) * PS + pg + k * PG];
          *s = dec * *s + acc[a][k];
        }
    }
    __syncthreads();  // the next chunk restages X, Bm, Cm
  }

  for (int e = tid; e < N * P; e += THREADS)
    final_state[sbase + e] = S[(e / P) * PS + e % P];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* init_state, void* y, void* final_state,
           const Strides* st, int B, int T_len, int H, int G, int N, int P,
           int Q, cudaStream_t stream) {
  const int smem = smem_bytes(N, P, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(init_state),
      static_cast<float*>(y), static_cast<float*>(final_state), st[0], st[1],
      st[2], st[3], st[4], T_len, H, G, N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the tensor-core variant
constexpr int PT = 16;         // state columns (of P) a block owns
// a masked exponent, as the plain version masks: exp gives 0, and no
// positive segment sum is ever exponentiated
constexpr float NEG_INF = -1e30f;

// two float32 values as bf16 pairs hi = bf16(v) and lo = bf16(v - hi), the
// first value in the low half (the lower column of an mma fragment)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// the hi/lo copy of a warp's state fragments, which c.S_prev reads: rows
// n and n + 8, columns 8 pt + 2 qd and the next
__device__ __forceinline__ void put_state(const float (&s)[2][4],
                                          __nv_bfloat16* Shi,
                                          __nv_bfloat16* Slo, Tile tx, int n,
                                          int qd) {
#pragma unroll
  for (int pt = 0; pt < 2; ++pt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t hi, lo;
      split2(s[pt][2 * r], s[pt][2 * r + 1], hi, lo);
      const int o = toff(tx, n + 8 * r, 8 * pt + 2 * qd);
      *reinterpret_cast<uint32_t*>(Shi + o) = hi;
      *reinterpret_cast<uint32_t*>(Slo + o) = lo;
    }
}

// running sum of dt * A over a chunk of Q (a multiple of 32) steps, by one
// warp (the SIMT kernel inlines the same scan): Q / 32 consecutive steps a
// lane, then a scan across the lanes
__device__ __forceinline__ void chunk_cumsum(const float* DT, float* CUM,
                                             float A, int Q, int lane) {
  const int per = Q / 32;
  float loc[MAX_Q / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k) {
    if (k < per) {
      run += DT[lane * per + k] * A;
      loc[k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < MAX_Q / 32; ++k)
    if (k < per) CUM[lane * per + k] = excl + loc[k];
}

struct MmaLayout {
  Tile tx, tn;
  int xb, nb, buf, sb, total;  // bytes
};

__host__ __device__ inline MmaLayout mma_layout(int N, int Q) {
  MmaLayout L;
  L.tx = tile_of(PT);
  L.tn = tile_of(N);
  L.xb = Q * L.tx.rsc * 16;              // x tile, Q x PT
  L.nb = Q * L.tn.rsc * 16;              // b or c, Q x N
  L.buf = L.xb + 2 * L.nb + Q * 4;       // x, b, c, dt of one chunk
  L.sb = N * L.tx.rsc * 16;              // hi or lo of the state, N x PT
  L.total = 2 * L.buf + 2 * L.sb + 2 * Q * 4;  // two buffers, S, cum, w
  return L;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_mma_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const __nv_bfloat16* __restrict__ b,
                    const __nv_bfloat16* __restrict__ c,
                    const float* __restrict__ init_state,
                    float* __restrict__ y, float* __restrict__ final_state,
                    Strides xs, Strides dts, Strides bs, Strides cs,
                    Strides ys, int T_len, int H, int G, int N, int P,
                    int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaLayout L = mma_layout(N, Q);
  const Tile tx = L.tx, tn = L.tn;
  __nv_bfloat16* Shi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * L.buf);
  __nv_bfloat16* Slo =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + 2 * L.buf + L.sb);
  float* CUM = reinterpret_cast<float*>(smem_raw + 2 * L.buf + 2 * L.sb);
  float* W = CUM + Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, qd = lane & 3;  // fragment row and column pair
  const int p0 = blockIdx.x * PT, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const float A = -expf(a_log[h]);

  const __nv_bfloat16* xb = x + bi * xs.b + h * xs.h + p0;
  const float* dtb = dt + bi * dts.b + h * dts.h;
  const __nv_bfloat16* bb = b + bi * bs.b + g * bs.h;
  const __nv_bfloat16* cb = c + bi * cs.b + g * cs.h;
  float* yb = y + bi * ys.b + h * ys.h + p0;
  const long long sbase = (static_cast<long long>(bi) * H + h) * N * P;
  const int nc = (T_len + Q - 1) / Q;
  const int nch = N / 8;

  // chunk ic into buffer k; steps past T are zeros with dt = 0
  auto stage = [&](int ic, int k) {
    unsigned char* base = smem_raw + k * L.buf;
    __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* Bm = reinterpret_cast<__nv_bfloat16*>(base + L.xb);
    __nv_bfloat16* Cm = reinterpret_cast<__nv_bfloat16*>(base + L.xb + L.nb);
    float* D = reinterpret_cast<float*>(base + L.xb + 2 * L.nb);
    const int t0 = ic * Q, valid = min(Q, T_len - t0);
    for (int e = tid; e < Q * (PT / 8); e += THREADS) {
      const int j = e / (PT / 8), ch = e % (PT / 8);
      __nv_bfloat16* dst = X + toff(tx, j, ch * 8);
      if (j < valid)
        cp_async16(dst, xb + static_cast<long long>(t0 + j) * xs.t + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int e = tid; e < Q * nch; e += THREADS) {
      const int j = e / nch, ch = e % nch;
      __nv_bfloat16* db = Bm + toff(tn, j, ch * 8);
      __nv_bfloat16* dc = Cm + toff(tn, j, ch * 8);
      if (j < valid) {
        cp_async16(db, bb + static_cast<long long>(t0 + j) * bs.t + ch * 8);
        cp_async16(dc, cb + static_cast<long long>(t0 + j) * cs.t + ch * 8);
      } else {
        *reinterpret_cast<uint4*>(db) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dc) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int j = tid; j < Q; j += THREADS) {
      if (j < valid)
        cp_async4(D + j, dtb + static_cast<long long>(t0 + j) * dts.t);
      else
        D[j] = 0.f;
    }
  };

  stage(0, 0);
  cp_async_commit();

  // warp w < N / 16 carries state rows n0..n0+15, columns p0..p0+15, as
  // two m16n8 accumulator fragments
  const bool owns_state = warp < N / 16;
  const int n0 = warp * 16;
  float s[2][4];
#pragma unroll
  for (int pt = 0; pt < 2; ++pt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + gr + 8 * (q >> 1), p = p0 + 8 * pt + 2 * qd + (q & 1);
      s[pt][q] = owns_state && init_state
                     ? init_state[sbase + static_cast<long long>(n) * P + p]
                     : 0.f;
    }
  if (owns_state) put_state(s, Shi, Slo, tx, n0 + gr, qd);

  // lane offsets of the four 8x8 matrices an ldmatrix.x4 reads: rows
  // 0..15 by (lane & 7) and bit 3, columns by bit 4 (an A operand, or a B
  // operand through .trans), or rows by bit 4 and columns by bit 3 (a B
  // operand read untransposed, or a transposed A operand)
  const int lr_a = (lane & 7) + ((lane >> 3) & 1) * 8, lc_a = (lane >> 4) * 8;
  const int lr_b = (lane & 7) + (lane >> 4) * 8, lc_b = ((lane >> 3) & 1) * 8;
  const uint32_t sh_base = smem_u32(Shi), sl_base = smem_u32(Slo);

  for (int ic = 0; ic < nc; ++ic) {
    const int k = ic & 1;
    if (ic + 1 < nc) {
      stage(ic + 1, k ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* base = smem_raw + k * L.buf;
    const __nv_bfloat16* X = reinterpret_cast<const __nv_bfloat16*>(base);
    const float* D = reinterpret_cast<const float*>(base + L.xb + 2 * L.nb);
    const uint32_t x_base = smem_u32(base);
    const uint32_t b_base = smem_u32(base + L.xb);
    const uint32_t c_base = smem_u32(base + L.xb + L.nb);
    const int t0 = ic * Q, valid = min(Q, T_len - t0);

    if (warp == 0) chunk_cumsum(D, CUM, A, Q, lane);
    __syncthreads();
    const float cum_last = CUM[Q - 1];
    for (int j = tid; j < Q; j += THREADS)
      W[j] = expf(cum_last - CUM[j]) * D[j];
    __syncthreads();

    // y for rows i0..i0+15 of the chunk, one 16-key tile at a time up to
    // the diagonal, as flash kernels walk their keys
    if (warp < Q / 16) {
      const int mt = warp, i0 = 16 * warp;
      uint32_t cf[MAX_N / 16][4];  // C fragments of these rows
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks)
        if (ks * 16 < N)
          ldsm_x4(cf[ks], c_base + 2 * toff(tn, i0 + lr_a, 16 * ks + lc_a));
      const int ia = i0 + gr, ib = ia + 8;
      const float ca = CUM[ia], cbv = CUM[ib];
      float yacc[2][4] = {}, iacc[2][4] = {};
      for (int kk = 0; kk <= mt; ++kk) {
        // G = C.B^T for keys 16 kk..16 kk+15: two n8 tiles, each summed
        // over even and odd depth steps apart to shorten the mma chains
        uint32_t bf[MAX_N / 16][4];
#pragma unroll
        for (int ks = 0; ks < MAX_N / 16; ++ks)
          if (ks * 16 < N)
            ldsm_x4(bf[ks], b_base + 2 * toff(tn, 16 * kk + lr_b,
                                              16 * ks + lc_b));
        float g[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < MAX_N / 16; ++ks) {
          if (ks * 16 < N) {
            mma16816(g[0][ks & 1], cf[ks], bf[ks][0], bf[ks][1]);
            mma16816(g[1][ks & 1], cf[ks], bf[ks][2], bf[ks][3]);
          }
        }
        // att_ij = G_ij exp(cum_i - cum_j) dt_j for j <= i, else 0: the mask
        // selects the exponent, so no branch is taken around each exp (a
        // branch there measured slower)
        float at[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * kk + 8 * h + 2 * qd + e;
            const float cj = CUM[j], dj = D[j];
            const float ga = g[h][0][e] + g[h][1][e];
            const float gb = g[h][0][2 + e] + g[h][1][2 + e];
            at[h][e] = ga * expf(j <= ia ? ca - cj : NEG_INF) * dj;
            at[h][2 + e] = gb * expf(j <= ib ? cbv - cj : NEG_INF) * dj;
          }
        // att.X: the two accumulator tiles are the A fragment of this key
        // step, split into hi + lo
        uint32_t ahi[4], alo[4];
        split2(at[0][0], at[0][1], ahi[0], alo[0]);
        split2(at[0][2], at[0][3], ahi[1], alo[1]);
        split2(at[1][0], at[1][1], ahi[2], alo[2]);
        split2(at[1][2], at[1][3], ahi[3], alo[3]);
        uint32_t bx[4];
        ldsm_x4_t(bx, x_base + 2 * toff(tx, 16 * kk + lr_a, lc_a));
        mma16816(yacc[0], ahi, bx[0], bx[1]);
        mma16816(yacc[0], alo, bx[0], bx[1]);
        mma16816(yacc[1], ahi, bx[2], bx[3]);
        mma16816(yacc[1], alo, bx[2], bx[3]);
      }
      // C.S_prev, S_prev as hi + lo
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks) {
        if (ks * 16 < N) {
          uint32_t bh[4], bl[4];
          const int o = 2 * toff(tx, 16 * ks + lr_a, lc_a);
          ldsm_x4_t(bh, sh_base + o);
          ldsm_x4_t(bl, sl_base + o);
          mma16816(iacc[0], cf[ks], bh[0], bh[1]);
          mma16816(iacc[0], cf[ks], bl[0], bl[1]);
          mma16816(iacc[1], cf[ks], bh[2], bh[3]);
          mma16816(iacc[1], cf[ks], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (r ? ib : ia);
        if (i < valid) {
          const float e = expf(r ? cbv : ca);
          float* row = yb + static_cast<long long>(t0 + i) * ys.t + 2 * qd;
#pragma unroll
          for (int pt = 0; pt < 2; ++pt) {
            row[8 * pt] = yacc[pt][2 * r] + e * iacc[pt][2 * r];
            row[8 * pt + 1] = yacc[pt][2 * r + 1] + e * iacc[pt][2 * r + 1];
          }
        }
      }
    }

    // S = exp(cum_last) S + B^T.(w x), B^T read transposed, w x as hi + lo
    if (owns_state) {
      const float dec = expf(cum_last);
#pragma unroll
      for (int pt = 0; pt < 2; ++pt)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[pt][q] *= dec;
#pragma unroll
      for (int kk = 0; kk < MAX_Q / 16; ++kk) {
        if (kk * 16 < Q) {
          uint32_t a[4];
          ldsm_x4_t(a, b_base + 2 * toff(tn, 16 * kk + lr_b, n0 + lc_b));
          const int j = 16 * kk + 2 * qd;
#pragma unroll
          for (int pt = 0; pt < 2; ++pt) {
            const int p = 8 * pt + gr;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int jj = j + (q & 1) + 8 * (q >> 1);
              v[q] = W[jj] * __bfloat162float(X[toff(tx, jj, p)]);
            }
            uint32_t h0, l0, h1, l1;
            split2(v[0], v[1], h0, l0);
            split2(v[2], v[3], h1, l1);
            mma16816(s[pt], a, h0, h1);
            mma16816(s[pt], a, l0, l1);
          }
        }
      }
    }
    __syncthreads();  // every read of this buffer and of Shi, Slo is done
    if (owns_state) put_state(s, Shi, Slo, tx, n0 + gr, qd);
  }

  if (owns_state) {
#pragma unroll
    for (int pt = 0; pt < 2; ++pt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + gr + 8 * (q >> 1);
        const int p = p0 + 8 * pt + 2 * qd + (q & 1);
        final_state[sbase + static_cast<long long>(n) * P + p] = s[pt][q];
      }
  }
}

int launch_mma(const void* x, const void* dt, const void* a_log,
               const void* b, const void* c, const void* init_state, void* y,
               void* final_state, const Strides* st, int B, int T_len, int H,
               int G, int N, int P, int Q, cudaStream_t stream) {
  const int smem = mma_layout(N, Q).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P / PT, H, B);
  ssd_mma_bf16_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const float*>(init_state), static_cast<float*>(y),
      static_cast<float*>(final_state), st[0], st[1], st[2], st[3], st[4],
      T_len, H, G, N, P, Q);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

extern "C" int ssd_fwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* init_state,
                       void* y, void* final_state, const long long* strides,
                       int B, int T, int H, int G, int N, int P, int chunk,
                       int dtype, void* stream) {
  if (!final_state || B <= 0 || B > 65535 || T <= 0 || H <= 0 || G <= 0 ||
      H % G != 0 || N < 8 || N > MAX_N || N % 8 != 0 || P < 4 || P > MAX_P ||
      P % 4 != 0 || chunk < 32 || chunk > MAX_Q || chunk % 32 != 0)
    return -1;
  Strides st[5];
  for (int t = 0; t < 5; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, b, c, init_state, y, final_state, st,
                         B, T, H, G, N, P, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, init_state, y,
                                 final_state, st, B, T, H, G, N, P, chunk, s);
  return -1;
}

extern "C" int ssd_fwd_smem_bytes(int N, int P, int chunk) {
  return smem_bytes(N, P, chunk);
}

extern "C" int ssd_fwd_mma(const void* x, const void* dt, const void* a_log,
                           const void* b, const void* c,
                           const void* init_state, void* y,
                           void* final_state, const long long* strides,
                           int B, int T, int H, int G, int N, int P,
                           int chunk, void* stream) {
  // bf16 x, b, c; 16-byte aligned pointers and row strides (cp.async);
  // the chunk a multiple of 32 (the running sum's lanes)
  if (!final_state || B <= 0 || B > 65535 || T <= 0 || H <= 0 ||
      H > 65535 || G <= 0 || H % G != 0 || N < 16 || N > MAX_N ||
      N % 16 != 0 || P < PT || P > MAX_P || P % PT != 0 || chunk < 32 ||
      chunk > MAX_Q || chunk % 32 != 0 || !aligned16(x) || !aligned16(b) ||
      !aligned16(c))
    return -1;
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
    // x, b, c: bf16 strides that keep every row 16-byte aligned
    if ((t == 0 || t == 2 || t == 3) &&
        (st[t].b % 8 != 0 || st[t].t % 8 != 0 || st[t].h % 8 != 0))
      return -1;
  }
  return launch_mma(x, dt, a_log, b, c, init_state, y, final_state, st, B,
                    T, H, G, N, P, chunk, static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_fwd_mma_smem_bytes(int N, int P, int chunk) {
  (void)P;  // a block holds PT columns of P, whatever P is
  return mma_layout(N, chunk).total;
}

extern "C" const char* ssd_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
