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
// Design for this card.  The TPU walks the chunks as a sequential grid
// axis that carries the state in VMEM scratch; here blocks run in parallel
// in no order, so one thread block owns one (batch, head) and loops over
// the chunks itself, keeping the state in shared memory (N x P floats,
// 32 KB at N = 128, P = 64).  Head h reads group h / (H / G) of b and c
// straight through their strides: there is no repeat of b and c to heads.
// Each chunk is staged in shared memory as float32 (x: Q x P, b and c:
// Q x N, one float of row padding against bank conflicts), then the block
// computes y in tiles of 32 rows (the tile's attention rows, 32 x Q, are
// staged too, and only keys j below the tile's last row are touched),
// then updates the state.  Every thread owns a small register tile of
// each product (4 x 4 of c.b^T, 2 x 4 of y, 8 x 4 of the state) with
// strided rows and columns, so neighbouring threads read neighbouring
// shared-memory rows or one broadcast word.  At N = 128, P = 64, Q = 128
// that is 216,704 bytes of dynamic shared memory, above the 48 KB static
// limit, so every launch raises the function's limit first.
//
// What bounds it.  At the serving path's shapes (B = 1, H = 32, P = 64,
// G = 1, N = 128, Q = 128, bf16 x, b, c) a prefill of T = 384 moves about
// 7 MB (x bf16, y float32, dt, b, c, two states): about 2 us at 3.35 TB/s,
// so the card's bound is memory.  This kernel is far from it: it runs only
// B * H = 32 blocks on 132 SMs, and each block issues its ~4M scalar
// float32 FMAs per chunk from shared memory.  Tensor cores (mma.sync, then
// wgmma) for c.b^T, att.x, c.S and b^T.x, and splitting the P axis (whose
// columns of the state are independent) over more blocks are the later
// steps; this version is the simple one that is right.
//
// Layout.  x (B, T, H, P), dt (B, T, H), b and c (B, T, G, N) and y
// (B, T, H, P) are indexed through their own element strides for the
// batch, step and head (or group) axes; the last axis of x, b, c and y
// must be unit-stride.  So the model's slices of its conv output go in as
// views, with no copy.  a_log (H,), init_state and final_state
// (B, H, N, P) are contiguous float32.  x, b and c are float32 or bf16;
// dt and y are float32.
//
// Plain C interface (loaded with ctypes): ssd_fwd returns 0, a
// cudaError_t, or -1 for arguments it does not take (init_state may be
// null, final_state may not).  It allocates nothing
// and launches on the caller's stream.  ssd_fwd_smem_bytes gives the
// dynamic shared memory a launch of those sizes asks for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

extern "C" const char* ssd_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
