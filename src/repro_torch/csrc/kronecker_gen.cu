// The Graph500 Kronecker (R-MAT) generator's draws, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference draws them with numpy on the host
// (src/repro/graph/kronecker.py:19-36, `kronecker_edges`).  It was added
// because at the paper's Kronecker scale 25 those draws are 2 x 25 x 2^29 =
// 2.7e10 calls of numpy's `Generator.random`, minutes of host time.  It
// computes exactly what the reference computes before its permutation, bit
// for bit: numpy's PCG64 stream is a 128-bit LCG, so any draw of it can be
// reached by a jump-ahead, and every edge can be drawn on its own.
//
// The stream.  `np.random.default_rng(seed)` is PCG64 (PCG XSL RR 128/64):
// a step is  s <- s * MULT + inc  (mod 2^128), and a 64-bit output is taken
// from the state after the step, XSL-RR: x = hi(s) ^ lo(s) rotated right by
// s >> 122.  `random()` returns (x >> 11) * 2^-53.  So draw i of the stream
// is the output of the state i + 1 steps past the seeded one.
//
// The draws.  For m = 2^scale * edgefactor edges, bit b of edge e is
//
//   ii = draw(DRAWS_PER_BIT * b * m + e)     > ab
//   jj = draw(DRAWS_PER_BIT * b * m + m + e) > (ii ? c_norm : a_norm)
//
// (the reference's `rng.random(m)` twice a bit), OR-ed into src and dst as
// bit b.  Each threshold t is a double and x * 2^-53 is exact, so
// x * 2^-53 > t  <=>  x > floor(t * 2^53): the wrapper passes those
// integers, computed exactly from the host's own doubles
// (`kernels/kronecker/ops.py:thresholds`), and no float is formed here.
//
// Design.  k steps of the LCG are one affine map s -> a s + c (mod 2^128),
// and maps compose, so `jump` forms the map of any k in O(log k) products
// (Brown's jump-ahead, as numpy's `advance`).  One thread draws whole
// edges: edge e's 2 * scale draws sit m apart in the stream, so from the
// state of draw e the thread applies the map of m steps once a draw.  Thread
// t takes edges t, t + T, t + 2T, ... (T threads in the grid), so a warp
// writes 32 consecutive int64 of src and of dst; it reaches its first edge
// with one jump of t + 1 steps and each next one with the map of T steps.
// Every 128-bit product is `unsigned __int128`, every index 64-bit (draw
// indices reach 2.7e10 at scale 25).
//
// What bounds it.  It reads nothing and writes 16 bytes an edge, 8.6 GB at
// scale 25: 2.6 ms at 3.35 TB/s.  Its integer work is far larger: a draw is
// one 128-bit multiply-add and the XSL-RR output, a few tens of 32-bit
// instructions, 2.7e10 times.  So the instructions issued bound it;
// chip_smoke.py counts them from this kernel's SASS (the loop over bits is
// kept rolled for that: one iteration is DRAWS_PER_BIT draws).
//
// Plain C interface (loaded with ctypes): kronecker_gen returns 0, a
// cudaError_t, or -1 for arguments it does not take.  It allocates nothing
// and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned __int128 u128;

// numpy's PCG64 multiplier, PCG_DEFAULT_MULTIPLIER_128
constexpr uint64_t PCG_MULT_HI = 0x2360ED051FC65DA4ULL;
constexpr uint64_t PCG_MULT_LO = 0x4385DF649FCCF645ULL;
// Generator.random(): the top 53 bits of an output
constexpr int MANTISSA_SHIFT = 11;
// draws a bit of scale: m for ii, then m for jj
constexpr int DRAWS_PER_BIT = 2;
// threads a block; blocks at most a SM
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

struct Affine {
  u128 a, c;  // s -> a s + c (mod 2^128)
};

__device__ __forceinline__ u128 make_u128(uint64_t hi, uint64_t lo) {
  return ((u128)hi << 64) | lo;
}

__device__ __forceinline__ u128 apply(const Affine& f, u128 s) {
  return f.a * s + f.c;
}

// The map of k steps of the LCG, by squaring the map of one step.
__device__ Affine jump(unsigned long long k, u128 inc) {
  u128 a = 1, c = 0;
  u128 ma = make_u128(PCG_MULT_HI, PCG_MULT_LO), mc = inc;
  while (k) {
    if (k & 1) {
      a = a * ma;
      c = c * ma + mc;
    }
    mc = mc * (ma + 1);  // the map of 2j steps from that of j
    ma = ma * ma;
    k >>= 1;
  }
  return {a, c};
}

// XSL-RR output of a state, shifted to the 53 bits random() keeps.
__device__ __forceinline__ uint64_t draw53(u128 s) {
  const uint64_t hi = (uint64_t)(s >> 64), lo = (uint64_t)s;
  const uint64_t x = hi ^ lo;
  const unsigned r = (unsigned)(hi >> 58);
  return ((x >> r) | (x << ((64u - r) & 63u))) >> MANTISSA_SHIFT;
}

__global__ void __launch_bounds__(THREADS)
kronecker_gen_kernel(long long* __restrict__ src, long long* __restrict__ dst,
                     long long m, int scale, uint64_t s0_hi, uint64_t s0_lo,
                     uint64_t inc_hi, uint64_t inc_lo, uint64_t t_ab,
                     uint64_t t_c, uint64_t t_a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const u128 inc = make_u128(inc_hi, inc_lo);
  const Affine by_m = jump((unsigned long long)m, inc);
  const Affine by_stride = jump((unsigned long long)stride, inc);
  // the state of draw e: e + 1 steps past the seeded state
  u128 base = apply(jump((unsigned long long)e + 1, inc),
                    make_u128(s0_hi, s0_lo));
  for (; e < m; e += stride) {
    u128 s = base;  // draw DRAWS_PER_BIT * b * m + e, here b = 0
    long long u = 0, v = 0;
#pragma unroll 1
    for (int b = 0; b < scale; ++b) {
      const bool ii = draw53(s) > t_ab;
      s = apply(by_m, s);  // draw DRAWS_PER_BIT * b * m + m + e
      const bool jj = draw53(s) > (ii ? t_c : t_a);
      s = apply(by_m, s);  // draw DRAWS_PER_BIT * (b + 1) * m + e
      u |= (long long)ii << b;
      v |= (long long)jj << b;
    }
    src[e] = u;
    dst[e] = v;
    base = apply(by_stride, base);
  }
}

// One thread an edge, at most BLOCKS_PER_SM blocks an SM (the threads then
// stride over the edges).
cudaError_t grid_blocks(long long m, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (m + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  *blocks = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// src, dst: m int64 each, on the card.  (s0_hi, s0_lo) and (inc_hi,
// inc_lo): the PCG64 state and increment to draw from (draw 0 is the output
// one step past s0).  t_ab, t_c, t_a: floor(t * 2^53) of the thresholds
// ab, c_norm and a_norm.
int kronecker_gen(void* src, void* dst, long long m, int scale,
                  unsigned long long s0_hi, unsigned long long s0_lo,
                  unsigned long long inc_hi, unsigned long long inc_lo,
                  unsigned long long t_ab, unsigned long long t_c,
                  unsigned long long t_a, void* stream) {
  if (!src || !dst || m < 1 || scale < 1 || scale > 62) return -1;
  int blocks = 0;
  const cudaError_t err = grid_blocks(m, &blocks);
  if (err != cudaSuccess) return (int)err;
  kronecker_gen_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (long long*)src, (long long*)dst, m, scale, s0_hi, s0_lo, inc_hi,
      inc_lo, t_ab, t_c, t_a);
  return (int)cudaGetLastError();
}

// Blocks and threads a block of a launch over m edges.
int kronecker_gen_launch_shape(long long m, int* shape) {
  if (m < 1 || !shape) return -1;
  const cudaError_t err = grid_blocks(m, &shape[0]);
  if (err != cudaSuccess) return (int)err;
  shape[1] = THREADS;
  return 0;
}

const char* kronecker_error_string(int rc) {
  if (rc == -1) return "arguments not taken (m >= 1, 1 <= scale <= 62)";
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
