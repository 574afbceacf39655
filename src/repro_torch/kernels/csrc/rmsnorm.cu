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
// does the same f32 math with the `w` factor.
//
// Bound: memory. Each row is read once and written once, w read once:
// (elem_x * 2 * R * D + elem_w * D) bytes. At gemma2-27b's long prefill
// (4,352 rows of 4608, bf16) that is 80.2 MB, 23.9 us at 3.35 TB/s; at
// decode (4 rows) a launch is bound by its latency. The arithmetic (4
// flops an element) is far below the f32 rate.
//
// Design. A row is cut into vectors of 16 bytes (8 bf16 or 4 f32 values)
// where its base, the row strides and D allow it (the host's choice;
// otherwise a vector is one element, the scalar path). A segment of TPR
// threads normalises a row, each thread holding VPT vectors of it in
// registers, thread t taking vectors t, t + TPR, ... so neighbouring
// threads touch neighbouring 16 bytes. The host sizes VPT (a template
// bound) and TPR from D so that TPR * VPT covers the row's vectors with
// as few dead slots as it can (4608 bf16: 576 vectors, 96 threads x 6,
// none dead). A block holds max(1, 256 / TPR) segments and walks over
// row groups, grid-strided, with as many blocks as fit on the card at
// once: each thread reads and widens its share of w once, into
// registers, and keeps it for every row it normalises. The sum of
// squares is reduced in f32 by a shuffle tree within the segment (and,
// for segments of several warps, over the warps through shared memory).
// No fast-math: rsqrtf, and products and sums in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;  // threads a block aims at
constexpr int kMaxThreads = 1024;

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

// N values of T at p as floats: one aligned access of N * sizeof(T)
// bytes (a multiple of 4 and at most 32) when VEC, else N scalar loads
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float* f) {
  if constexpr (VEC) {
    constexpr int kBytes = N * static_cast<int>(sizeof(T));
    static_assert(kBytes % 8 == 0 && kBytes <= 32, "vector width");
    if constexpr (kBytes >= 16) {
      uint4 u[kBytes / 16];
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        u[i] = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(u);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(p[i]);
  }
}

// N values stored at p from floats (16 bytes, aligned, when VEC)
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float* f) {
  if constexpr (VEC) {
    static_assert(N * sizeof(T) == 16, "one 16-byte store");
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(f[i]);
  }
}

// The leading dims of x, at most three after merging: row r sits at
// (r / (n1 * n2)) * s0 + ((r / n2) % n1) * s1 + (r % n2) * s2 elements
// (32-bit division: the host keeps the row count below 2^31; one
// strided dim, the common case, needs none).
struct Rows {
  unsigned n1, n2;
  long long s0, s1, s2;
  __device__ __forceinline__ long long offset(long long r) const {
    if (n1 == 1 && n2 == 1) return r * s0;
    const unsigned u = static_cast<unsigned>(r);
    return static_cast<long long>(u / (n1 * n2)) * s0 +
           static_cast<long long>((u / n2) % n1) * s1 +
           static_cast<long long>(u % n2) * s2;
  }
};

// How a launch cuts rows: nv vectors a row, tpr threads a segment (a
// power of two up to 32, else a multiple of 32), segs segments a block.
struct Cut {
  int nv, tpr, segs;
};

template <typename TX, bool VEC>
__host__ __device__ constexpr int vec_elems() {
  return VEC ? 16 / static_cast<int>(sizeof(TX)) : 1;
}

// Threads a block of a thread holding n values of x (and n of w) in
// registers may have: 64 registers a thread at 1024, 128 at 512, 255 at
// 256.
__host__ __device__ constexpr int max_threads(int n) {
  return n <= 8 ? 1024 : (n <= 24 ? 512 : 256);
}

// E values of TX a vector (16 bytes when VEC, else 1), VPT vectors a
// thread.
template <typename TX, typename TW, bool VEC, int VPT>
__global__ void __launch_bounds__(max_threads(VPT * vec_elems<TX, VEC>()))
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, Rows rows, long long R, int D, Cut cut,
               float eps, float offset) {
  constexpr int E = vec_elems<TX, VEC>();
  __shared__ float partial[kMaxThreads / 32];
  const int tpr = cut.tpr;
  const int seg = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5;

  // (offset + w) for this thread's vectors, formed once in f32
  float wv[VPT][E];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    load<TW, E, VEC>(w + min(t + i * tpr, cut.nv - 1) * E, wv[i]);
#pragma unroll
    for (int e = 0; e < E; ++e) wv[i][e] = offset + wv[i][e];
  }

  const long long groups = (R + cut.segs - 1) / cut.segs;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long r = g * cut.segs + seg;
    const bool live = r < R;
    const TX* xr = x + (live ? rows.offset(r) : 0);
    // every load unconditional (a dead slot reads the row's last vector,
    // a dead row row 0), so all VPT are in flight at once; dead values
    // are then zeroed
    float v[VPT][E];
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      load<TX, E, VEC>(xr + min(t + i * tpr, cut.nv - 1) * E, v[i]);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const bool in = live && t + i * tpr < cut.nv;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[i][e] = in ? v[i][e] : 0.0f;
        ss = __fmaf_rn(v[i][e], v[i][e], ss);
      }
    }
    // the segment's sum: shuffles within it (a segment of <= 32 threads
    // is an aligned run of one warp), then over its warps
    const int width = tpr < 32 ? tpr : 32;
    for (int o = width >> 1; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (tpr > 32) {
      if ((threadIdx.x & 31) == 0) partial[warp] = ss;
      __syncthreads();
      const int w0 = seg * (tpr >> 5);
      ss = 0.0f;
      for (int i = 0; i < (tpr >> 5); ++i) ss += partial[w0 + i];
      __syncthreads();  // partial is rewritten by the next group
    }
    const float rms = rsqrtf(ss / static_cast<float>(D) + eps);
    TX* yr = y + r * D;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * tpr;
      if (live && c < cut.nv) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = v[i][e] * rms * wv[i][e];
        store<TX, E, VEC>(yr + c * E, o);
      }
    }
  }
}

constexpr int kVpts[] = {1, 2, 3, 4, 6, 8};

// The cut of a row of nv vectors of e values with the fewest dead
// slots (then a segment nearest 128 threads) that a block can launch;
// returns the chosen VPT (0 if none).
int choose(int nv, int e, Cut* cut) {
  int best_vpt = 0;
  long long best_dead = 0;
  double best_dist = 0.0;
  for (int vpt : kVpts) {
    int tpr = (nv + vpt - 1) / vpt;
    if (tpr <= 32) {
      int p = 1;
      while (p < tpr) p <<= 1;
      tpr = p;
    } else {
      tpr = (tpr + 31) / 32 * 32;
    }
    const int segs = tpr >= kBlockThreads ? 1 : kBlockThreads / tpr;
    if (tpr * segs > max_threads(vpt * e)) continue;
    const long long dead = static_cast<long long>(tpr) * vpt - nv;
    const double dist = tpr > 128 ? tpr / 128.0 : 128.0 / tpr;
    if (best_vpt == 0 || dead < best_dead ||
        (dead == best_dead && dist < best_dist)) {
      best_vpt = vpt;
      best_dead = dead;
      best_dist = dist;
      cut->tpr = tpr;
    }
  }
  cut->nv = nv;
  cut->segs = cut->tpr >= kBlockThreads ? 1 : kBlockThreads / cut->tpr;
  return best_vpt;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename TX, typename TW, bool VEC, int VPT>
int launch(const void* x, const void* w, void* y, Rows rows, long long R,
           int D, Cut cut, float eps, float offset, cudaStream_t s) {
  auto* kernel = rmsnorm_kernel<TX, TW, VEC, VPT>;
  const int threads = cut.tpr * cut.segs;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = (R + cut.segs - 1) / cut.segs;
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                     sm_count();
  if (blocks > groups) blocks = groups;
  kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, R, D, cut, eps, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, bool VEC>
int by_vpt(int vpt, const void* x, const void* w, void* y, Rows rows,
           long long R, int D, Cut cut, float eps, float offset,
           cudaStream_t s) {
  switch (vpt) {
    case 1: return launch<TX, TW, VEC, 1>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
    case 2: return launch<TX, TW, VEC, 2>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
    case 3: return launch<TX, TW, VEC, 3>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
    case 4: return launch<TX, TW, VEC, 4>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
    case 6: return launch<TX, TW, VEC, 6>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
    case 8: return launch<TX, TW, VEC, 8>(x, w, y, rows, R, D, cut, eps,
                                          offset, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TW>
int dispatch(const void* x, const void* w, void* y, long long n0,
             long long n1, long long n2, long long s0, long long s1,
             long long s2, int D, float eps, float offset, void* stream) {
  if (n0 < 0 || n1 < 1 || n2 < 1 || D < 1 || D > 8192)
    return cudaErrorInvalidValue;
  const long long R = n0 * n1 * n2;
  if (R == 0) return cudaSuccess;
  if (R > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Rows rows{static_cast<unsigned>(n1), static_cast<unsigned>(n2), s0,
                  s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors need D whole vectors, and every x row and w at a
  // 16-byte boundary (y is a new contiguous array)
  constexpr long long kE = 16 / static_cast<long long>(sizeof(TX));
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  const bool vec = D % kE == 0 && addr(x) % 16 == 0 && addr(w) % 16 == 0 &&
                   s0 % kE == 0 && s1 % kE == 0 && s2 % kE == 0;
  Cut cut;
  const int vpt = vec ? choose(static_cast<int>(D / kE),
                                static_cast<int>(kE), &cut)
                       : choose(D, 1, &cut);
  if (vpt == 0) return cudaErrorInvalidValue;
  return vec ? by_vpt<TX, TW, true>(vpt, x, w, y, rows, R, D, cut, eps,
                                    offset, s)
             : by_vpt<TX, TW, false>(vpt, x, w, y, rows, R, D, cut, eps,
                                     offset, s);
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
