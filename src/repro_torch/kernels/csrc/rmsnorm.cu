// RMSNorm for Hopper (sm_90a):
//   y[r, :] = x[r, :] * rsqrt(mean_d x[r, d]^2 + eps) * (offset + w)
// over the rows of x (..., D), in f32, written in x's dtype into a
// contiguous (rows, D) output. offset is a launch argument: 0 gives the
// reference kernel's form (scale by w), 1 the models' form (scale by
// 1 + w, the sum formed in f32). x is f32 or bf16, w (D,) f32 or bf16.
// x's rows may be strided in up to three leading dims; the last dim is
// contiguous.
//
// Replaces the Pallas TPU kernel `rmsnorm` in src/repro/kernels/rmsnorm.py
// (pallas_call at line 32), which tiles (256, D) row blocks into VMEM and
// does the same f32 math with the `w` factor. Here a row is read once
// into registers (each thread keeps its share of the row), its sum of
// squares is reduced in f32 by a warp shuffle tree (and, for wide rows,
// a second tree over the block's warps through shared memory), and the
// row is written once from the registers.
//
// Bound: memory. Each row is read once and written once, and w is read
// once per row from L2 (counted once): (elem_x * 2 * R * D + elem_w * D)
// bytes. At the stablelm-12b prefill shape (128 rows of 5120, bf16)
// that is 2.6 MB, 0.78 us at 3.35 TB/s; at decode (4 rows) 0.05 us, so
// a decode launch is bound by its latency. The arithmetic (4 flops an
// element) is far below the f32 rate. Design: one block of 256 threads
// per row for D > 1024, one warp per row (4 rows a block of 128
// threads) for D <= 1024; each thread holds VPT = D / threads (rounded
// up) values, with neighbouring threads on neighbouring addresses, so
// every load and store is coalesced. No fast-math: rsqrtf, and products
// and sums in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The leading dims of x, at most three after merging: row r sits at
// (r / (n1 * n2)) * s0 + ((r / n2) % n1) * s1 + (r % n2) * s2 elements.
struct Rows {
  long long n1, n2, s0, s1, s2;
  __device__ __forceinline__ long long offset(long long r) const {
    return (r / (n1 * n2)) * s0 + ((r / n2) % n1) * s1 + (r % n2) * s2;
  }
};

// THREADS threads normalise one row together (32: a warp; 256: a block);
// VPT values of the row per thread.
template <typename TX, typename TW, int THREADS, int VPT>
__global__ void __launch_bounds__(THREADS == 32 ? 128 : THREADS)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, Rows rows, long long R, int D, float eps,
               float offset) {
  constexpr int kPerBlock = THREADS == 32 ? 4 : 1;  // rows per block
  __shared__ float partial[THREADS == 32 ? 1 : THREADS / 32];
  const int t = THREADS == 32 ? (threadIdx.x & 31) : threadIdx.x;
  const long long r =
      static_cast<long long>(blockIdx.x) * kPerBlock +
      (THREADS == 32 ? (threadIdx.x >> 5) : 0);
  const bool live = r < R;
  const TX* xr = x + (live ? rows.offset(r) : 0);

  float v[VPT];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = t + i * THREADS;
    v[i] = (live && d < D) ? to_f(xr[d]) : 0.0f;
    ss = __fmaf_rn(v[i], v[i], ss);
  }
  ss = warp_sum(ss);
  if constexpr (THREADS > 32) {
    if ((t & 31) == 0) partial[t >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) ss += partial[i];
  }
  if (!live) return;
  const float rms = rsqrtf(ss / static_cast<float>(D) + eps);
  TX* yr = y + r * D;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = t + i * THREADS;
    if (d < D) yr[d] = from_f<TX>(v[i] * rms * (offset + to_f(w[d])));
  }
}

template <typename TX, typename TW, int THREADS, int VPT>
void launch(const void* x, const void* w, void* y, Rows rows, long long R,
            int D, float eps, float offset, cudaStream_t s) {
  const long long blocks = THREADS == 32 ? (R + 3) / 4 : R;
  rmsnorm_kernel<TX, TW, THREADS, VPT>
      <<<static_cast<unsigned>(blocks), THREADS == 32 ? 128 : THREADS, 0,
         s>>>(static_cast<const TX*>(x), static_cast<const TW*>(w),
              static_cast<TX*>(y), rows, R, D, eps, offset);
}

template <typename TX, typename TW>
int dispatch(const void* x, const void* w, void* y, long long n0,
             long long n1, long long n2, long long s0, long long s1,
             long long s2, int D, float eps, float offset, void* stream) {
  if (n0 < 0 || n1 < 1 || n2 < 1 || D < 1 || D > 8192)
    return cudaErrorInvalidValue;
  const long long R = n0 * n1 * n2;
  if (R == 0) return cudaSuccess;
  if ((D <= 1024 ? (R + 3) / 4 : R) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Rows rows{n1, n2, s0, s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 256)
    launch<TX, TW, 32, 8>(x, w, y, rows, R, D, eps, offset, s);
  else if (D <= 512)
    launch<TX, TW, 32, 16>(x, w, y, rows, R, D, eps, offset, s);
  else if (D <= 1024)
    launch<TX, TW, 32, 32>(x, w, y, rows, R, D, eps, offset, s);
  else if (D <= 2048)
    launch<TX, TW, 256, 8>(x, w, y, rows, R, D, eps, offset, s);
  else if (D <= 4096)
    launch<TX, TW, 256, 16>(x, w, y, rows, R, D, eps, offset, s);
  else
    launch<TX, TW, 256, 32>(x, w, y, rows, R, D, eps, offset, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, w, y, n0, n1, n2, s0, s1, s2, D, eps, offset, stream): x's rows are
// indexed by (i0 < n0, i1 < n1, i2 < n2) at i0*s0 + i1*s1 + i2*s2
// elements, each D contiguous values; y is a new contiguous
// (n0*n1*n2, D) array of x's dtype. D <= 8192. Returns the cudaError_t
// of the launch.
#define RMSNORM_ENTRY(NAME, TX, TW)                                         \
  extern "C" int NAME(const void* x, const void* w, void* y, long long n0,  \
                      long long n1, long long n2, long long s0,             \
                      long long s1, long long s2, int D, float eps,         \
                      float offset, void* stream) {                         \
    return dispatch<TX, TW>(x, w, y, n0, n1, n2, s0, s1, s2, D, eps,        \
                            offset, stream);                                \
  }
RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
