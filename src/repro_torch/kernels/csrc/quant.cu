// Wire-format quantization kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of src/repro/kernels/quant.py:
//  * `quantize` (pallas_call at line 81): (R, L) f32 -> per-128-lane-tile
//    symmetric fp8-e4m3 / int8 payload (R, Lp) + one f32 abs-max scale per
//    tile (R, nt), Lp = nt * 128;
//  * `dequantize` (pallas_call at line 103): payload rows times their tile
//    scales, (W, Lp) -> (W, out_len) f32. Like quant_reduce it also takes
//    row tables: result row out_rows[b] of `out` (f32 or bf16) is payload
//    row rows[b] decoded (-1 = zeros), so the executor lands a whole
//    movement phase in one launch;
//  * `quant_reduce_requant` (pallas_call at line 176): quant_reduce of K
//    operand rows with no partial, then the `quantize` encoding of the
//    sum, (K, Lp) -> (Lp,) wire + (nt,) f32, never leaving registers;
//  * `quant_reduce` (pallas_call at lines 147/151): K wire rows decoded
//    (q * scale) and summed in f32, plus an optional resident partial
//    `own`, batched here as (B, K, Lp) -> (B, Lp) so that one fold phase of
//    the schedule executor covers every rank of the local mesh. Like
//    fused_reduce.cu it also takes row tables: operand k of batch row b is
//    payload/scale row rows[b * K + k] (-1 = skipped), the partial is row
//    own_rows[b] of `own` and the result lands in row out_rows[b] of `out`
//    (f32 or bf16), so the executor folds straight from its staging
//    buffers into its working buffer with no copy around the launch.
//
// Bound: memory, for all four. quantize must read 4 * L bytes and write
// Lp + 4 * nt bytes per row; quant_reduce must read K operand rows at wire
// width (K * Lp bytes + 4 * K * nt of scales) plus the `own` partial and
// write the result, about (K + 1) * Lp bytes at wire width plus the
// partial and result, over the H100's 3.35 TB/s. The arithmetic
// (a divide per element, a warp max per tile, a multiply-add per operand
// element) stays far below the card's rates. Design:
//  * quantize: one warp per 128-lane tile, 4 lanes per thread loaded as one
//    16-byte vector (coalesced), the tile's abs-max by warp shuffles (no
//    shared memory), each thread writes its 4 payload bytes as one 32-bit
//    word and lane 0 the scale. The tile is divided by the safe scale (a
//    true IEEE divide, never a multiply by a reciprocal, so the payload
//    bytes equal the reference's); int8 rounds half to even (rintf) and
//    then clips, fp8 clips and then converts with saturating
//    round-to-nearest-even. The ragged last tile is masked in the kernel.
//  * quant_reduce: each thread owns 16 lanes, reads them from each of the K
//    operand rows as one 16-byte vector (a loop over operands inside the
//    thread), decodes in registers and accumulates in f32: no operand is
//    ever decompressed to device memory. A masked operand (row -1) is never
//    read, and an operand tile whose scale is 0 (an all-zero tile) is
//    skipped, so neither's payload bits, whatever they are, reach the sum.
//  * dequantize: 4 lanes a thread, a warp a tile, so a warp reads 128
//    contiguous payload bytes and writes 128 contiguous results; bound by
//    its f32 writes (4 bytes out per byte in). A zero-scale tile writes
//    exact zeros without reading its payload (a NaN pattern times 0 would
//    be NaN).
//  * quant_reduce_requant: one warp per 128-lane tile, 4 lanes a thread
//    (one 32-bit payload word per operand, a warp reads 128 contiguous
//    bytes; eight operands' loads in flight together), the operands
//    summed in quant_reduce's order, the tile's abs-max by warp shuffles
//    and the encoding of quantize_kernel, so its bytes equal
//    quantize(quant_reduce(q, s)) bit for bit. Bound: reading K payload
//    rows; it writes a wire row, 1/K of what it reads.
// Products and sums use the _rn intrinsics (no fused multiply-add), so the
// results equal the plain versions (repro_torch/kernels/ref.py) bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;
constexpr int kFp8 = 0;
constexpr int kInt8 = 1;
constexpr int kBatch = 8;  // operands quant_reduce_requant loads together

template <int WIRE>
__device__ __forceinline__ std::uint32_t encode(float y, float qmax) {
  if (WIRE == kInt8) {
    y = fminf(fmaxf(rintf(y), -qmax), qmax);
    return static_cast<std::uint32_t>(
        static_cast<std::uint8_t>(static_cast<std::int8_t>(y)));
  }
  y = fminf(fmaxf(y, -qmax), qmax);
  return static_cast<std::uint32_t>(
      __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
}

template <int WIRE>
__device__ __forceinline__ float decode(std::uint8_t b) {
  if (WIRE == kInt8) return static_cast<float>(static_cast<std::int8_t>(b));
  __half_raw h = __nv_cvt_fp8_to_halfraw(b, __NV_E4M3);
  return __half2float(__half(h));
}

// The encoding of one 128-lane tile held by a whole warp, 4 lanes a
// thread: returns this thread's 4 payload bytes packed in one word and
// sets *scale to the tile's stored scale (0 for an all-zero tile). The
// tile is divided by the safe scale with a true IEEE divide.
template <int WIRE>
__device__ __forceinline__ std::uint32_t encode_tile(const float (&v)[4],
                                                     float* scale) {
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float qmax = WIRE == kInt8 ? 127.0f : 448.0f;
  const float s = __fdiv_rn(amax, qmax);
  const float safe = s > 0.0f ? s : 1.0f;
  std::uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed |= encode<WIRE>(__fdiv_rn(v[i], safe), qmax) << (8 * i);
  *scale = amax > 0.0f ? s : 0.0f;
  return packed;
}

// grid: ceil(R * nt / warps per block) blocks; one warp per (row, tile).
template <int WIRE>
__global__ void __launch_bounds__(256)
quantize_kernel(const float* __restrict__ x, std::uint8_t* __restrict__ q,
                float* __restrict__ scales, long long R, long long L,
                long long nt, int vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long id =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (id >= R * nt) return;  // the whole warp leaves together
  const long long r = id / nt;
  const long long t = id - r * nt;
  const float* row = x + r * L;
  const long long l0 = t * kTile + lane * 4;
  float v[4];
  if (vec && l0 + 4 <= L) {
    const float4 f = *reinterpret_cast<const float4*>(row + l0);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = l0 + i < L ? row[l0 + i] : 0.0f;
  }
  float scale;
  const std::uint32_t packed = encode_tile<WIRE>(v, &scale);
  const long long Lp = nt * kTile;
  *reinterpret_cast<std::uint32_t*>(q + r * Lp + l0) = packed;
  if (lane == 0) scales[r * nt + t] = scale;
}

// grid: ceil(nt / warps per block) blocks; one warp per 128-lane tile of
// the K operand rows (K, Lp), 4 lanes a thread. IN: operand wire; OUT:
// result wire.
template <int IN, int OUT>
__global__ void __launch_bounds__(256)
quant_reduce_requant_kernel(const std::uint8_t* __restrict__ q,
                            const float* __restrict__ scales, int K,
                            std::uint8_t* __restrict__ qout,
                            float* __restrict__ sout, long long nt) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= nt) return;  // the whole warp leaves together
  const long long Lp = nt * kTile;
  const long long l0 = t * kTile + lane * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // kBatch operands at a time: their scales, then their payload words
  // (a zero-scale tile's never read), are loaded together so the loads
  // overlap; the adds still run in operand order
  for (int k0 = 0; k0 < K; k0 += kBatch) {
    float sc[kBatch];
    std::uint32_t w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      sc[u] = k0 + u < K ? scales[(k0 + u) * nt + t] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      w[u] = sc[u] != 0.0f ? *reinterpret_cast<const std::uint32_t*>(
                                 q + (k0 + u) * Lp + l0)
                           : 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (sc[u] == 0.0f) continue;  // all-zero tile or past K
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i],
                           __fmul_rn(decode<IN>(static_cast<std::uint8_t>(
                                         w[u] >> (8 * i))),
                                     sc[u]));
    }
  }
  float scale;
  const std::uint32_t packed = encode_tile<OUT>(acc, &scale);
  *reinterpret_cast<std::uint32_t*>(qout + l0) = packed;
  if (lane == 0) sout[t] = scale;
}

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

template <typename T>
struct alignas(sizeof(T) * 4) Vec4 {
  T v[4];
};

// grid: (ceil(Lp / (16 * threads)), B); 16 lanes per thread. T: partial
// and result type. Null tables mean the dense form: operand k of batch row
// b is payload row b * K + k, the partial and result rows are b. Partial
// and result rows are own_len and out_len elements long (<= Lp); lanes past
// them are not read or written.
template <int WIRE, typename T>
__global__ void __launch_bounds__(128)
quant_reduce_kernel(const std::uint8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    const long long* __restrict__ rows, int K, const T* own,
                    const long long* __restrict__ own_rows, long long own_len,
                    T* out, const long long* __restrict__ out_rows,
                    long long out_len, long long Lp, int own_vec,
                    int out_vec) {
  const long long b = blockIdx.y;
  const long long l0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (l0 >= Lp) return;
  const long long nt = Lp / kTile;
  const long long t = l0 / kTile;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long r = rows != nullptr ? rows[b * K + k] : b * K + k;
    if (r < 0) continue;  // masked operand
    const float sc = scales[r * nt + t];
    if (sc == 0.0f) continue;  // all-zero tile
    const uint4 raw = *reinterpret_cast<const uint4*>(q + r * Lp + l0);
    const std::uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const std::uint8_t byte =
          static_cast<std::uint8_t>(w[i >> 2] >> (8 * (i & 3)));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(decode<WIRE>(byte), sc));
    }
  }
  const long long orow =
      own == nullptr ? -1 : (own_rows != nullptr ? own_rows[b] : b);
  if (orow >= 0) {
    const T* ob = own + orow * own_len;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long l = l0 + 4 * c;
      if (own_vec && l + 4 <= own_len) {
        const Vec4<T> o = *reinterpret_cast<const Vec4<T>*>(ob + l);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * c + i] = __fadd_rn(acc[4 * c + i], to_f32(o.v[i]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (l + i < own_len)
            acc[4 * c + i] = __fadd_rn(acc[4 * c + i], to_f32(ob[l + i]));
      }
    }
  }
  T* wb = out + (out_rows != nullptr ? out_rows[b] : b) * out_len;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long l = l0 + 4 * c;
    if (out_vec && l + 4 <= out_len) {
      Vec4<T> o;
#pragma unroll
      for (int i = 0; i < 4; ++i) o.v[i] = from_f32<T>(acc[4 * c + i]);
      *reinterpret_cast<Vec4<T>*>(wb + l) = o;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (l + i < out_len) wb[l + i] = from_f32<T>(acc[4 * c + i]);
    }
  }
}

// grid: (ceil(out_len / (4 * threads)), B); 4 lanes per thread, so a
// warp covers one 128-lane tile: it reads 128 contiguous payload bytes and
// writes 128 contiguous results. T: result type. Null tables mean the
// dense form: result row b is payload row b. Result rows are out_len
// elements long (<= Lp); lanes past them are not read or written.
template <int WIRE, typename T>
__global__ void __launch_bounds__(256)
dequantize_kernel(const std::uint8_t* __restrict__ q,
                  const float* __restrict__ scales,
                  const long long* __restrict__ rows, T* __restrict__ out,
                  const long long* __restrict__ out_rows, long long out_len,
                  long long Lp, int out_vec) {
  const long long b = blockIdx.y;
  const long long l0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (l0 >= out_len) return;
  const long long r = rows != nullptr ? rows[b] : b;
  const float sc = r >= 0 ? scales[r * (Lp / kTile) + l0 / kTile] : 0.0f;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (sc != 0.0f) {  // no row, or an all-zero tile: exact zeros, unread
    const std::uint32_t w =
        *reinterpret_cast<const std::uint32_t*>(q + r * Lp + l0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __fmul_rn(decode<WIRE>(static_cast<std::uint8_t>(w >> (8 * i))),
                       sc);
  }
  T* wb = out + (out_rows != nullptr ? out_rows[b] : b) * out_len + l0;
  if (out_vec && l0 + 4 <= out_len) {
    Vec4<T> o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.v[i] = from_f32<T>(v[i]);
    *reinterpret_cast<Vec4<T>*>(wb) = o;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (l0 + i < out_len) wb[i] = from_f32<T>(v[i]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

bool aligned4(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 4 == 0;
}

template <int WIRE>
int launch_quantize(const void* x, void* q, void* scales, long long R,
                    long long L, long long nt, void* stream) {
  if (R <= 0 || L <= 0 || nt != (L + kTile - 1) / kTile)
    return cudaErrorInvalidValue;
  if (!aligned4(q)) return cudaErrorMisalignedAddress;
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  const int vec = aligned16(x) && L % 4 == 0;
  const long long blocks = (R * nt + kWarps - 1) / kWarps;
  quantize_kernel<WIRE><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<std::uint8_t*>(q),
      static_cast<float*>(scales), R, L, nt, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WIRE, typename T>
int launch_quant_reduce(const void* q, const void* scales, const void* rows,
                        int K, const void* own, const void* own_rows,
                        long long own_len, void* out, const void* out_rows,
                        long long out_len, long long B, long long Lp,
                        void* stream) {
  if (B <= 0 || K <= 0 || Lp <= 0 || B > 65535 || Lp % kTile != 0 ||
      out_len <= 0 || out_len > Lp ||
      (own != nullptr && (own_len <= 0 || own_len > Lp)))
    return cudaErrorInvalidValue;
  if (!aligned16(q)) return cudaErrorMisalignedAddress;
  constexpr int kThreads = 128;
  constexpr std::uintptr_t kVecBytes = 4 * sizeof(T);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const int own_vec =
      own != nullptr && addr(own) % kVecBytes == 0 && own_len % 4 == 0;
  const int out_vec = addr(out) % kVecBytes == 0 && out_len % 4 == 0;
  const long long spans = Lp / 16;
  dim3 grid(static_cast<unsigned>((spans + kThreads - 1) / kThreads),
            static_cast<unsigned>(B));
  quant_reduce_kernel<WIRE, T><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const std::uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<const long long*>(rows), K, static_cast<const T*>(own),
      static_cast<const long long*>(own_rows), own_len, static_cast<T*>(out),
      static_cast<const long long*>(out_rows), out_len, Lp, own_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WIRE, typename T>
int launch_dequantize(const void* q, const void* scales, const void* rows,
                      void* out, const void* out_rows, long long out_len,
                      long long B, long long Lp, void* stream) {
  if (B <= 0 || Lp <= 0 || B > 65535 || Lp % kTile != 0 || out_len <= 0 ||
      out_len > Lp)
    return cudaErrorInvalidValue;
  if (!aligned4(q)) return cudaErrorMisalignedAddress;
  constexpr int kThreads = 256;
  const int out_vec =
      reinterpret_cast<std::uintptr_t>(out) % (4 * sizeof(T)) == 0 &&
      out_len % 4 == 0;
  const long long spans = (out_len + 3) / 4;
  dim3 grid(static_cast<unsigned>((spans + kThreads - 1) / kThreads),
            static_cast<unsigned>(B));
  dequantize_kernel<WIRE, T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const std::uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<const long long*>(rows), static_cast<T*>(out),
      static_cast<const long long*>(out_rows), out_len, Lp, out_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int IN, int OUT>
int launch_quant_reduce_requant(const void* q, const void* scales, int K,
                                void* qout, void* sout, long long Lp,
                                void* stream) {
  if (K <= 0 || Lp <= 0 || Lp % kTile != 0) return cudaErrorInvalidValue;
  if (!aligned4(q) || !aligned4(qout)) return cudaErrorMisalignedAddress;
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  const long long nt = Lp / kTile;
  const long long blocks = (nt + kWarps - 1) / kWarps;
  quant_reduce_requant_kernel<IN, OUT><<<static_cast<unsigned>(blocks),
                                         kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const std::uint8_t*>(q), static_cast<const float*>(scales),
      K, static_cast<std::uint8_t*>(qout), static_cast<float*>(sout), nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quantize_fp8(const void* x, void* q, void* scales, long long R,
                            long long L, long long nt, void* stream) {
  return launch_quantize<kFp8>(x, q, scales, R, L, nt, stream);
}

extern "C" int quantize_int8(const void* x, void* q, void* scales,
                             long long R, long long L, long long nt,
                             void* stream) {
  return launch_quantize<kInt8>(x, q, scales, R, L, nt, stream);
}

// quant_reduce entries: (q, scales, rows, K, own, own_rows, own_len, out,
// out_rows, out_len, B, Lp, stream), by wire and by partial/result type;
// pass null tables (and a null `own`) for the dense form.
#define QUANT_REDUCE_ENTRY(NAME, WIRE, T)                                     \
  extern "C" int NAME(const void* q, const void* scales, const void* rows,   \
                      int K, const void* own, const void* own_rows,          \
                      long long own_len, void* out, const void* out_rows,    \
                      long long out_len, long long B, long long Lp,          \
                      void* stream) {                                        \
    return launch_quant_reduce<WIRE, T>(q, scales, rows, K, own, own_rows,   \
                                        own_len, out, out_rows, out_len, B,  \
                                        Lp, stream);                         \
  }

QUANT_REDUCE_ENTRY(quant_reduce_fp8_f32, kFp8, float)
QUANT_REDUCE_ENTRY(quant_reduce_fp8_bf16, kFp8, __nv_bfloat16)
QUANT_REDUCE_ENTRY(quant_reduce_int8_f32, kInt8, float)
QUANT_REDUCE_ENTRY(quant_reduce_int8_bf16, kInt8, __nv_bfloat16)

// dequantize entries: (q, scales, rows, out, out_rows, out_len, B, Lp,
// stream), by wire and result type; null tables for the dense form.
#define DEQUANTIZE_ENTRY(NAME, WIRE, T)                                       \
  extern "C" int NAME(const void* q, const void* scales, const void* rows,   \
                      void* out, const void* out_rows, long long out_len,    \
                      long long B, long long Lp, void* stream) {             \
    return launch_dequantize<WIRE, T>(q, scales, rows, out, out_rows,        \
                                      out_len, B, Lp, stream);               \
  }

DEQUANTIZE_ENTRY(dequantize_fp8_f32, kFp8, float)
DEQUANTIZE_ENTRY(dequantize_fp8_bf16, kFp8, __nv_bfloat16)
DEQUANTIZE_ENTRY(dequantize_int8_f32, kInt8, float)
DEQUANTIZE_ENTRY(dequantize_int8_bf16, kInt8, __nv_bfloat16)

// quant_reduce_requant entries: (q, scales, K, qout, sout, Lp, stream), by
// operand wire and result wire.
#define REQUANT_ENTRY(NAME, IN, OUT)                                          \
  extern "C" int NAME(const void* q, const void* scales, int K, void* qout,  \
                      void* sout, long long Lp, void* stream) {              \
    return launch_quant_reduce_requant<IN, OUT>(q, scales, K, qout, sout,    \
                                                Lp, stream);                 \
  }

REQUANT_ENTRY(quant_reduce_requant_fp8_fp8, kFp8, kFp8)
REQUANT_ENTRY(quant_reduce_requant_fp8_int8, kFp8, kInt8)
REQUANT_ENTRY(quant_reduce_requant_int8_fp8, kInt8, kFp8)
REQUANT_ENTRY(quant_reduce_requant_int8_int8, kInt8, kInt8)
