// Fused N-ary reduction for Hopper (sm_90a): B rows of out, each the f32
// sum of x operand rows (plus an optional resident partial).
//
// Replaces the Pallas TPU kernel `fused_reduce` in
// src/repro/kernels/fused_reduce.py (pallas_call at line 58), which sums
// x operand rows of one (x, L) array in one memory pass. The port batches
// B independent reductions into one launch so that one fold phase of the
// schedule executor covers every rank of the local mesh; B = 1 with no
// tables is the TPU kernel's shape. Two forms share the kernel:
//  * dense: parts (B, x, L) -> out (B, L), every row of `parts` an operand;
//  * gathered: operand k of batch row b is row rows[b * x + k] of `src`
//    (-1 = skipped), the partial is row own_rows[b] of `own` (-1 = none),
//    and the result lands in row out_rows[b] of `out`. The executor folds
//    a whole phase this way straight out of its staging buffer into its
//    working buffer, with no gather, concatenation or scatter copy around
//    the launch. A result row may be its own partial row (read, then
//    written, by the same thread).
//
// Bound: memory. The function must read each live operand row and partial
// once and write each result row once, (x + 1) * L * sizeof(T) bytes per
// batch row in the dense form, over the H100's 3.35 TB/s; it does x adds
// per output element, far below the card's add rate. Design: every thread
// owns one 16-byte vector of operand lanes (4 f32 or 8 bf16), loads that
// vector from each operand row in turn (neighbouring threads read
// neighbouring 16-byte words, so every load is coalesced) and keeps the
// running sum in f32 registers, so each operand byte is read exactly once
// and each output byte written once. One thread block covers one
// contiguous span of lanes of one batch row; the operand axis is a loop
// inside the thread. The ragged edge is masked in the kernel: when L is
// not a multiple of the vector width (or a pointer is not aligned for it)
// the host launches the one-lane-per-thread instance instead, so no
// padding copy is ever made. Sums start at 0 and run in operand order with
// the partial last, so the result equals the plain version
// (repro_torch/kernels/ref.py) bit for bit.
//
// The same file replaces the Pallas TPU kernel `grouped_reduce`
// (src/repro/kernels/fused_reduce.py, pallas_call at line 95): the same
// (x, L) -> (L,) sum folded as a tree of fan_in-ary adds, level k summing
// groups of fan_in consecutive level-(k-1) values left to right, the last
// group of a level zero-padded. The TPU kernel holds all x operands of a
// tile in VMEM and folds level by level; here each operand is streamed
// once (the same coalesced 16-byte vectors as fused_reduce) into one f32
// accumulator per tree level, driven by a base-fan_in digit counter: when
// a level holds fan_in values it adds its sum into the level above, and at
// the end every part-filled level is carried up in order. The pad zeros
// are never added: a sum that starts at +0 is never -0, so adding +0
// changes nothing. Bound: memory, (x + 1) * L elements, as fused_reduce;
// the depth (accumulators a thread) is a template bound, at most
// kMaxDepth.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// S: operand type; T: partial and result type. VEC lanes per thread. The
// host guarantees L % VEC == 0 for VEC > 1, so a vector is either wholly
// inside the row or wholly past its end. Null tables mean the dense form.
template <typename S, typename T, int VEC>
__global__ void __launch_bounds__(256)
fused_reduce_kernel(const S* __restrict__ src,
                    const long long* __restrict__ rows, int x,
                    const T* own, const long long* __restrict__ own_rows,
                    T* out, const long long* __restrict__ out_rows,
                    long long L) {
  const long long b = blockIdx.y;
  const long long l0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (l0 >= L) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int k = 0; k < x; ++k) {
    const long long r = rows != nullptr ? rows[b * x + k] : b * x + k;
    if (r < 0) continue;  // masked operand
    const Vec<S, VEC> in = *reinterpret_cast<const Vec<S, VEC>*>(src + r * L + l0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], to_f32(in.v[i]));
  }
  if (own != nullptr) {
    const long long r = own_rows != nullptr ? own_rows[b] : b;
    if (r >= 0) {
      const Vec<T, VEC> o = *reinterpret_cast<const Vec<T, VEC>*>(own + r * L + l0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], to_f32(o.v[i]));
    }
  }
  const long long r = out_rows != nullptr ? out_rows[b] : b;
  Vec<T, VEC> res;
#pragma unroll
  for (int i = 0; i < VEC; ++i) res.v[i] = from_f32<T>(acc[i]);
  *reinterpret_cast<Vec<T, VEC>*>(out + r * L + l0) = res;
}

template <int VEC, typename T>
bool vec_ok(const T* p) {
  return p == nullptr ||
         reinterpret_cast<std::uintptr_t>(p) % (sizeof(T) * VEC) == 0;
}

template <typename S, typename T>
int launch(const void* src_, const void* rows, int x, const void* own_,
           const void* own_rows, void* out_, const void* out_rows,
           long long B, long long L, void* stream) {
  if (B <= 0 || L <= 0 || x <= 0 || B > 65535) return cudaErrorInvalidValue;
  const S* src = static_cast<const S*>(src_);
  const T* own = static_cast<const T*>(own_);
  T* out = static_cast<T*>(out_);
  const auto* r = static_cast<const long long*>(rows);
  const auto* orow = static_cast<const long long*>(own_rows);
  const auto* wrow = static_cast<const long long*>(out_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  constexpr int kVec = 16 / sizeof(S);
  if (L % kVec == 0 && vec_ok<kVec>(src) && vec_ok<kVec>(own) &&
      vec_ok<kVec>(static_cast<const T*>(out))) {
    const long long vecs = L / kVec;
    dim3 grid(static_cast<unsigned>((vecs + kThreads - 1) / kThreads),
              static_cast<unsigned>(B));
    fused_reduce_kernel<S, T, kVec><<<grid, kThreads, 0, s>>>(
        src, r, x, own, orow, out, wrow, L);
  } else {
    dim3 grid(static_cast<unsigned>((L + kThreads - 1) / kThreads),
              static_cast<unsigned>(B));
    fused_reduce_kernel<S, T, 1><<<grid, kThreads, 0, s>>>(
        src, r, x, own, orow, out, wrow, L);
  }
  return static_cast<int>(cudaGetLastError());
}

// Deepest tree the kernel folds: one accumulator a level and the result.
constexpr int kMaxDepth = 7;

// T: operand and result type. VEC lanes per thread, L % VEC == 0 for VEC
// > 1. DEPTH: levels of the tree (a template bound, so every loop over
// levels unrolls to constant indices and acc stays in registers). Level
// k's accumulator acc[k] collects cnt[k] values; acc[DEPTH] is the result.
template <typename T, int VEC, int DEPTH>
__global__ void __launch_bounds__(256)
grouped_reduce_kernel(const T* __restrict__ parts, T* __restrict__ out,
                      int x, int fan, long long L) {
  const long long l0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (l0 >= L) return;
  float acc[DEPTH + 1][VEC];
  int cnt[DEPTH + 1];
#pragma unroll
  for (int k = 0; k <= DEPTH; ++k) {
    cnt[k] = 0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.0f;
  }
  for (int j = 0; j < x; ++j) {
    const Vec<T, VEC> in =
        *reinterpret_cast<const Vec<T, VEC>*>(parts + j * L + l0);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[0][i] = __fadd_rn(acc[0][i], to_f32(in.v[i]));
    ++cnt[0];
    // a full level hands its sum to the level above and starts a new group
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      if (cnt[k] == fan) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[k + 1][i] = __fadd_rn(acc[k + 1][i], acc[k][i]);
          acc[k][i] = 0.0f;
        }
        cnt[k] = 0;
        ++cnt[k + 1];
      }
    }
  }
  // the part-filled groups, bottom up
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    if (cnt[k] > 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[k + 1][i] = __fadd_rn(acc[k + 1][i], acc[k][i]);
      ++cnt[k + 1];
    }
  }
  Vec<T, VEC> res;
#pragma unroll
  for (int i = 0; i < VEC; ++i) res.v[i] = from_f32<T>(acc[DEPTH][i]);
  *reinterpret_cast<Vec<T, VEC>*>(out + l0) = res;
}

// The kernel instance of the run's depth (0..kMaxDepth).
template <typename T, int VEC, int DEPTH = 0>
void launch_grouped_depth(int depth, long long lanes, cudaStream_t s,
                          const T* parts, T* out, int x, int fan,
                          long long L) {
  if constexpr (DEPTH < kMaxDepth) {
    if (depth != DEPTH)
      return launch_grouped_depth<T, VEC, DEPTH + 1>(depth, lanes, s, parts,
                                                     out, x, fan, L);
  }
  constexpr int kThreads = 256;
  grouped_reduce_kernel<T, VEC, DEPTH>
      <<<static_cast<unsigned>((lanes + kThreads - 1) / kThreads), kThreads,
         0, s>>>(parts, out, x, fan, L);
}

template <typename T>
int launch_grouped(const void* parts_, void* out_, int x, int fan,
                   long long L, void* stream) {
  if (x <= 0 || fan < 2 || L <= 0) return cudaErrorInvalidValue;
  int depth = 0;
  for (long long n = x; n > 1; n = (n + fan - 1) / fan) ++depth;
  if (depth > kMaxDepth) return cudaErrorInvalidValue;
  const T* parts = static_cast<const T*>(parts_);
  T* out = static_cast<T*>(out_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  if (L % kVec == 0 && vec_ok<kVec>(parts) && vec_ok<kVec>(out))
    launch_grouped_depth<T, kVec>(depth, L / kVec, s, parts, out, x, fan, L);
  else
    launch_grouped_depth<T, 1>(depth, L, s, parts, out, x, fan, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: (src, rows, x, own, own_rows, out, out_rows, B, L, stream);
// pass null tables (and a null `own`) for the dense form.
extern "C" int fused_reduce_f32(const void* src, const void* rows, int x,
                                const void* own, const void* own_rows,
                                void* out, const void* out_rows, long long B,
                                long long L, void* stream) {
  return launch<float, float>(src, rows, x, own, own_rows, out, out_rows, B,
                              L, stream);
}

extern "C" int fused_reduce_bf16(const void* src, const void* rows, int x,
                                 const void* own, const void* own_rows,
                                 void* out, const void* out_rows, long long B,
                                 long long L, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(src, rows, x, own, own_rows,
                                              out, out_rows, B, L, stream);
}

// bf16 operands (a bf16 wire), f32 partial and result.
extern "C" int fused_reduce_bf16_f32(const void* src, const void* rows, int x,
                                     const void* own, const void* own_rows,
                                     void* out, const void* out_rows,
                                     long long B, long long L, void* stream) {
  return launch<__nv_bfloat16, float>(src, rows, x, own, own_rows, out,
                                      out_rows, B, L, stream);
}

// grouped_reduce entries: (parts (x, L), out (L,), x, fan_in, L, stream).
extern "C" int grouped_reduce_f32(const void* parts, void* out, int x,
                                  int fan, long long L, void* stream) {
  return launch_grouped<float>(parts, out, x, fan, L, stream);
}

extern "C" int grouped_reduce_bf16(const void* parts, void* out, int x,
                                   int fan, long long L, void* stream) {
  return launch_grouped<__nv_bfloat16>(parts, out, x, fan, L, stream);
}
