// RG-LRU recurrence (RecurrentGemma / Griffin), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rglru_kernel` / `rglru_fwd` of
// src/repro/kernels/rglru/kernel.py.  It computes the same function as the
// plain version (repro_torch/kernels/rglru/ref.py), per (batch, channel w),
// in float32 and with the reference's formulas:
//
//   log_a_t = -8 softplus(lam_w) r_t
//   b_t     = sqrt(max(1 - exp(2 log_a_t), 1e-12)) (i_t x_t)
//   h_t     = exp(log_a_t) h_{t-1} + b_t      h_{-1} = h0 (zeros when null)
//
// with softplus(l) = max(l, 0) + log1p(exp(-|l|)), i.e. logaddexp(l, 0).
//
// Unlike the TPU kernel it also takes an initial state h0 and writes the
// final state h_{T-1}, which is what serving prefill needs, and it takes any
// T >= 1 and any width W.
//
// Design for this card.  The TPU kernel walks time blocks as a sequential
// grid axis carrying h in VMEM scratch, and inside a block builds a
// (bt x bt x bw) decay tensor so that its vector unit has a wide product to
// do.  A GPU needs none of that: one thread owns one (batch, channel) and
// walks T in order with h in a register.  Consecutive threads take
// consecutive channels, so every load and store of a warp is one coalesced
// 128-byte line.  a_t and b_t do not depend on h, so the time loop runs in
// groups of U steps: the x, r, i of the next group are loaded into
// registers while the current group's coefficients and its chain of U
// fused multiply-adds are computed, which keeps up to 2U steps of loads in
// flight per thread.
//
// What bounds it.  Every input is read once and every output written once:
// at the serving path's shape (B = 1, W = 4096, float32 x, r, i in, h out,
// lam, h0 and the final state) that is 4 W (4 T + 3) bytes, 33.5 MB at
// T = 511, 0.010 ms at 3.35 TB/s; the operations (a few exp, a sqrt and a
// log1p a step) are far below the card's rate.  So the bound is memory.  At
// B W = 4096 threads the card can keep only ~1.5 MB of loads in flight
// (4096 threads x 2U steps x 12 bytes), short of the ~2 MB that 3.35 TB/s
// times a ~600 ns memory latency needs, so this kernel is latency-bound at
// B = 1.  Measured on the H100 (chip_smoke.py phase 13) it takes 0.134 us a
// step at B = 1, W = 4096, about 7x its bound: its 128 warps leave three of
// every four of the card's warp schedulers idle, so each step's loads and
// transcendental math are latency-bound.  Splitting T across blocks (a
// two-pass chunked scan: per-chunk products of a, then the carries) is the
// later step; this version is the simple one that is right.
//
// Layout.  x, r, i (B, T, W) are float32 and indexed through their own
// element strides for the batch and step axes; their last axis must be
// unit-stride.  h (B, T, W), lam (W,), h0 and h_last (B, W) are contiguous
// float32.
//
// Plain C interface (loaded with ctypes): rglru_fwd returns 0, a
// cudaError_t, or -1 for arguments it does not take (h0 may be null,
// h_last may not).  It allocates nothing and launches on the caller's
// stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int U = 16;        // time steps per register group
constexpr float C = 8.0f;

__device__ __forceinline__ float softplus(float l) {
  return fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
}

__device__ __forceinline__ void load_group(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ i, long long st_x, long long st_r,
    long long st_i, int t0, int T, float (&xv)[U], float (&rv)[U],
    float (&iv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    const bool live = t < T;
    xv[u] = live ? __ldg(x + t * st_x) : 0.f;
    rv[u] = live ? __ldg(r + t * st_r) : 0.f;
    iv[u] = live ? __ldg(i + t * st_i) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) rglru_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ i, const float* __restrict__ lam,
    const float* __restrict__ h0, float* __restrict__ h,
    float* __restrict__ h_last, long long sb_x, long long st_x,
    long long sb_r, long long st_r, long long sb_i, long long st_i, int T,
    int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const float c = -C * softplus(lam[w]);
  const float* xp = x + bi * sb_x + w;
  const float* rp = r + bi * sb_r + w;
  const float* ip = i + bi * sb_i + w;
  float* hp = h + static_cast<long long>(bi) * T * W + w;
  float hc = h0 ? h0[static_cast<long long>(bi) * W + w] : 0.f;

  float xv[U], rv[U], iv[U];
  load_group(xp, rp, ip, st_x, st_r, st_i, 0, T, xv, rv, iv);
  for (int t0 = 0; t0 < T; t0 += U) {
    float xn[U] = {}, rn[U] = {}, in_[U] = {};
    if (t0 + U < T)
      load_group(xp, rp, ip, st_x, st_r, st_i, t0 + U, T, xn, rn, in_);
    float a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float log_a = c * rv[u];
      a[u] = expf(log_a);
      b[u] = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (iv[u] * xv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < T) {
        hc = fmaf(a[u], hc, b[u]);
        hp[static_cast<long long>(t0 + u) * W] = hc;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = xn[u];
      rv[u] = rn[u];
      iv[u] = in_[u];
    }
  }
  h_last[static_cast<long long>(bi) * W + w] = hc;
}

}  // namespace

extern "C" int rglru_fwd(const void* x, const void* r, const void* i,
                         const void* lam, const void* h0, void* h,
                         void* h_last, const long long* strides, int B, int T,
                         int W, void* stream) {
  if (!h_last || B <= 0 || B > 65535 || T <= 0 || W <= 0) return -1;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(i), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5], T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
