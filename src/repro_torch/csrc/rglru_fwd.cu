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
// What bounds it.  Every input is read once and every output written once:
// at the serving path's shape (B = 1, W = 4096, float32 x, r, i in, h out,
// lam, h0 and the final state) that is 4 W (4 T + 3) bytes, 33.5 MB at
// T = 511, 0.010 ms at 3.35 TB/s; the operations (two exp, a sqrt and a few
// multiplies a step) are far below the card's rate.  So the bound is memory,
// and a kernel reaches it only with enough loads in flight: 3.35 TB/s times
// a ~600 ns memory latency is ~2 MB.  A walk of T by one thread per
// (batch, channel) has B W = 4096 threads at B = 1, 64 blocks of 2 warps,
// and cannot keep that much in flight.
//
// Design: a block-local segmented scan.  a_t and b_t do not depend on h,
// and the recurrence composes associatively: (a1, b1) then (a2, b2) is
// (a1 a2, a2 b1 + b2).  A block owns WT = 32 consecutive channels of one
// batch row; its 512 threads are S = 16 segments x 32 channels, so a warp
// is 32 consecutive channels at one step and every load and store is one
// 128-byte line.  The grid is (ceil(W / 32), B): 128 blocks of 16 warps at
// the path's shape, one per SM.  The block walks T in spans of S L steps;
// in a span thread (s, w) takes steps [s L, (s + 1) L) of channel w:
//
//   1. from the segment's x, r, i, already in registers, it forms a_t and
//      b_t and scans the segment from zero, keeping in registers the local
//      states hl_t and the running products P_t of a;
//   2. it issues the loads of its segment in the next span (3 L a thread,
//      about 12 MB in flight across the card at L = 16), writes the
//      segment's pair (P_end, hl_end) to shared memory, and after one
//      barrier composes the span's incoming carry with the pairs of the
//      segments before its own (at most S - 1 multiply-adds), and with all
//      S of them for the next span's carry;
//   3. it writes h_t = hl_t + P_t carry_in (one fused multiply-add).
//
// So the next span's loads are in flight during this span's barrier,
// carries and stores.  The pairs are double-buffered by span, so one
// barrier a span suffices.  No block waits on another and nothing goes
// through device memory twice.  Steps past T, and channels past W, are the
// identity pair (1, 0), so the composed carry after the last span is
// h_{T-1}, bit for bit the last written h.  L is a template argument: 8
// where one span of 128 steps covers T, so that a short prompt does not
// leave most threads idle, else 16.  Registers cap it: a thread holds
// 5 L values (hl, P and the next x, r, i), and at L = 16 ptxas fits them
// in 127 of the 128 registers a thread of a 512-thread block may use.
// L = 32 without the prefetch (2 L values) already spilled, and ran
// slower than two spans at L = 16.
//
// The product rule.  P_t is the running product of the same float32 a_t
// that the serial recurrence multiplies by (not exp of a running sum of
// log a_t, as the TPU kernel forms it); the plain version composes the same
// products in log depth.  At saturated gates (a_t a few ulps below 1) the
// two rules round differently, so this choice is what the kernel is held
// to.
//
// Layout.  x, r, i (B, T, W) are float32 and indexed through their own
// element strides for the batch and step axes; their last axis must be
// unit-stride.  h (B, T, W), lam (W,), h0 and h_last (B, W) are contiguous
// float32.
//
// Plain C interface (loaded with ctypes): rglru_fwd returns 0, a
// cudaError_t, or -1 for arguments it does not take (h0 may be null,
// h_last may not).  It allocates nothing and launches on the caller's
// stream.  rglru_fwd_launch_shape reports the launch a call makes.

#include <cuda_runtime.h>

namespace {

constexpr int WT = 32;  // channels per block: one warp's width
constexpr int S = 16;   // segments per span: one warp each
constexpr float C = 8.0f;

__host__ __device__ constexpr int segment_steps(int T) {
  return S * 8 >= T ? 8 : 16;
}

__device__ __forceinline__ float softplus(float l) {
  return fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
}

template <int L>
__device__ __forceinline__ void load_segment(
    const float* __restrict__ xp, const float* __restrict__ rp,
    const float* __restrict__ ip, long long st_x, long long st_r,
    long long st_i, int ts, int T, bool on, float (&xv)[L], float (&rv)[L],
    float (&iv)[L]) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const long long t = ts + u;
    const bool live = on && t < T;
    xv[u] = live ? __ldg(xp + t * st_x) : 0.f;
    rv[u] = live ? __ldg(rp + t * st_r) : 0.f;
    iv[u] = live ? __ldg(ip + t * st_i) : 0.f;
  }
}

template <int L>
__global__ void __launch_bounds__(WT * S, 1) rglru_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ i, const float* __restrict__ lam,
    const float* __restrict__ h0, float* __restrict__ h,
    float* __restrict__ h_last, long long sb_x, long long st_x,
    long long sb_r, long long st_r, long long sb_i, long long st_i, int T,
    int W) {
  __shared__ float pair_a[2][S][WT];
  __shared__ float pair_h[2][S][WT];
  const int lane = threadIdx.x;
  const int seg = threadIdx.y;
  const int w = blockIdx.x * WT + lane;
  const long long bi = blockIdx.y;
  const bool on = w < W;
  const float c = on ? -C * softplus(lam[w]) : 0.f;
  const float* xp = x + bi * sb_x + w;
  const float* rp = r + bi * sb_r + w;
  const float* ip = i + bi * sb_i + w;
  float* hp = h + bi * T * W + w;
  float carry = on && h0 ? h0[bi * W + w] : 0.f;

  float xv[L], rv[L], iv[L];
  load_segment(xp, rp, ip, st_x, st_r, st_i, seg * L, T, on, xv, rv, iv);
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += S * L, buf ^= 1) {
    const int ts = t0 + seg * L;
    // 1. the segment's local scan from zero
    float hl[L], pr[L];
    float hc = 0.f, pc = 1.f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const bool live = on && ts + u < T;
      const float log_a = c * rv[u];
      const float a = live ? expf(log_a) : 1.f;
      const float b =
          live ? sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) *
                     (iv[u] * xv[u])
               : 0.f;
      hc = fmaf(a, hc, b);
      pc *= a;
      hl[u] = hc;
      pr[u] = pc;
    }
    // 2. the next span's loads, in flight during this span's barrier,
    // carries and stores
    if (t0 + S * L < T)
      load_segment(xp, rp, ip, st_x, st_r, st_i, ts + S * L, T, on, xv, rv,
                   iv);
    // the carries through the span's segment pairs
    pair_a[buf][seg][lane] = pc;
    pair_h[buf][seg][lane] = hc;
    __syncthreads();
    float cin = carry;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j == seg) cin = carry;
      carry = fmaf(pair_a[buf][j][lane], carry, pair_h[buf][j][lane]);
    }
    // 3. the segment's states from its true incoming carry
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const long long t = ts + u;
      if (on && t < T) hp[t * W] = fmaf(pr[u], cin, hl[u]);
    }
  }
  if (on && seg == 0) h_last[bi * W + w] = carry;
}

template <int L>
void launch(const dim3& grid, cudaStream_t stream, const void* x,
            const void* r, const void* i, const void* lam, const void* h0,
            void* h, void* h_last, const long long* st, int T, int W) {
  rglru_fwd_kernel<L><<<grid, dim3(WT, S), 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(i), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), st[0], st[1], st[2], st[3], st[4], st[5],
      T, W);
}

}  // namespace

extern "C" int rglru_fwd_launch_shape(int B, int T, int W, int* shape) {
  if (B <= 0 || B > 65535 || T <= 0 || W <= 0) return -1;
  const int L = segment_steps(T);
  shape[0] = (W + WT - 1) / WT * B;       // blocks
  shape[1] = WT * S;                      // threads per block
  shape[2] = L;                           // steps per segment
  shape[3] = S;                           // segments per span
  shape[4] = (T + S * L - 1) / (S * L);   // spans
  return 0;
}

extern "C" int rglru_fwd(const void* x, const void* r, const void* i,
                         const void* lam, const void* h0, void* h,
                         void* h_last, const long long* strides, int B, int T,
                         int W, void* stream) {
  if (!h_last || B <= 0 || B > 65535 || T <= 0 || W <= 0) return -1;
  const int L = segment_steps(T);
  const auto run = L == 8 ? &launch<8> : &launch<16>;
  run(dim3((W + WT - 1) / WT, B), static_cast<cudaStream_t>(stream), x, r, i,
      lam, h0, h, h_last, strides, T, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
