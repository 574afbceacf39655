// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// a causal mask, a sliding window and a tanh logit soft-cap, queries
// right-aligned to the keys, per batch row an optional count of visible
// keys. For batch row b, query head h and query i (0 <= i < Tq), with
// n = kv_len[b] (default Tk, clamped to [0, Tk]) and position
// p_i = n - Tq + i, over the keys j < n of key head h / (Hq / Hkv):
//   s_ij = q_i . k_j * scale;  s_ij = softcap * tanh(s_ij / softcap)
//   visible: (!causal || j <= p_i) && (window <= 0 || j > p_i - window)
//   out_i = sum_j e_ij v_j / (sum_j e_ij + 1e-30),  e_ij = exp(s_ij - m_i)
// with e_ij = 0 for a hidden key, so a row that sees no key gives 0.
// q, k, v are (B, H, T, D) arrays of one dtype (f32 or bf16) with
// explicit strides in B, H and T (the last dim contiguous); out is
// written in q's dtype in the (B, Tq, Hq, D) layout, the layout the
// models multiply by the output projection.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at line 95). That
// kernel's grid is (B, Hq, q-blocks, kv-blocks) with the kv axis run in
// order, the running (m, l, acc) kept in VMEM scratch across it and
// fully masked kv blocks skipped. Blocks on the card run in no order, so
// here a block walks the kv tiles of its rows itself, only those the
// causal bound, the window and kv_len leave visible, with the state
// (m, l and each row's share of acc) in f32 registers. Every kernel packs
// the query rows of a key head's GQA group into one block (row r is
// query r / group of query head hk * group + r % group), so one staged
// K/V tile serves the whole group and no copy of the cache is made.
//
// Bound: the larger of bytes and operations. Bytes: q, the visible K/V
// rows and out once. Operations: 4 * Hq * D per visible score (two
// products), on the bf16 tensor cores for bf16 inputs (989 TFLOP/s), the
// f32 units for f32 (67 TFLOP/s). Three kernels, chosen by the host on
// shape and dtype:
// - Tq <= kDecodeTq (decode), either dtype: flash_decode_kernel. Bound by
//   bytes (every score is two flops a byte of the cache), so the design
//   keeps every SM reading: the visible keys of a (key head, batch row)
//   are dealt in tiles to `splits` blocks, the most that still run at
//   once one an SM (the host's choice from B, Hkv and Tk, no sync on
//   kv_len), which form one thread-block cluster; a block holds up to 8
//   query rows of its key head (in bf16 the whole GQA group of every
//   served model at decode), so each K/V byte is read once; up to eight
//   warps a block each stream their own tiles through a ring of bulk
//   copies (TMA, completion on an mbarrier), the next tiles in flight
//   while one is worked. What is left at decode sizes is latency, not
//   bandwidth: in bf16 the products run on the tensor cores (mma.sync,
//   the 16 keys of a tile as M, the group's rows as N), so a tile is a
//   short chain of instructions. The warps' (m, l, acc) merge in shared
//   memory, the splits' through distributed shared memory after a
//   cluster barrier, each block merging a slice of the outputs in split
//   order: one launch, no workspace, no atomics, and a result that does
//   not depend on the order the blocks ran in.
// - bf16 with Tq > kDecodeTq (prefill): flash_tc_kernel, bound by
//   operations at long prompts: wgmma on the tensor cores, K/V tiles
//   staged by cp.async two deep (see the kernel's note below).
// - f32 with Tq > kDecodeTq: flash_tf32_kernel, bound by operations too,
//   on the f32 units' 67 TFLOP/s; its products go to the tensor cores
//   instead (mma.sync m16n8k8) in 3xTF32: one TF32 term keeps 11 bits of
//   an f32 input, too few for the f32 check (1e-5 of a row's largest
//   |value|), so each operand x is split into hi (x cut to TF32) and lo
//   = x - hi, and lo hi + hi lo + hi hi accumulate in f32, about 21 bits
//   a product (lo lo is dropped). Blocks of 16 rows, their four warps
//   splitting each key tile, give enough blocks to fill the SMs at the
//   f32 models' small shapes and short dependency chains a warp.
// tanhf without fast-math; expf in f32, exp2f on base-2 scores in bf16;
// the mask zeroes each weight after the exp (two hidden scores would
// give exp(0) = 1 otherwise).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kDecodeTq = 4;        // query rows a head at most (decode)
constexpr float kNegInf = -1e30f;   // the masked score, as the reference

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

struct Strides {
  long long b, h, t;  // elements
};

template <typename T>
__host__ __device__ constexpr int vec_elems() {  // elements in 16 B
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or zeros when !in (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes at p (16-byte aligned) as floats
__device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
// two neighbouring floats at p (their pair aligned)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Tq > kDecodeTq in bf16 (prefill): the tensor-core kernel. A block of one
// warpgroup (4 warps) takes kTcRows = 64 rows of the row space of one
// (key head, batch row), in which row r is query r / group of query head
// hk * group + r % group: the group's heads share every K/V tile, and a
// tile's rows span few query positions, so the causal and window bounds
// still cut its key range. K/V tiles of BK keys are staged in bf16 in
// shared memory by 16-byte cp.async copies, kTcStages tiles deep (the
// next tile in flight while this one is multiplied), through L1 (a
// 32-byte sector that two threads copy is then one L2 read). Per tile the
// warpgroup computes the 64 x BK scores S = Q K^T with wgmma (Q and K read
// from shared memory through descriptors, f32 accumulators in registers:
// each warp holds its 16 rows), soft-caps and masks them in registers
// (the mask only on tiles a bound cuts), updates each row's running max
// and sum with quad shuffles, and adds P V to its f32 accumulator with
// wgmma, P the A operand from registers (the score fragments, no round
// trip through shared memory) and V read transposed from shared memory.
// P is carried as the sum of two bf16 terms, hi = bf16(p) and lo =
// bf16(p - hi), two products into one accumulator, so the weights keep
// 16 bits: one term (8 bits, how FlashAttention-2 and SDPA round P) errs
// by up to 2^-9 of each weight, which the output's 2^-8 check (one bf16
// rounding) does not leave room for. Tiles lie in shared memory in
// wgmma's canonical no-swizzle layout: 8 x 8 core matrices of 128
// contiguous bytes, the 16-byte chunk c of row r at c * rows * 16 +
// r * 16 bytes. Rows of D are zero-padded to DP, the template bound (64,
// 128, 160 or 256; Q and K columns past D are zeros, which add nothing to
// S; O columns past D are not written). Where a row of q, k or v is not
// 16-byte aligned (D not a multiple of 8, or a stride), tiles are staged
// element by element instead. The row tiles launch last-first, so the
// tiles that see the most keys (causal) start first and the short ones
// fill the tail. The output goes out through shared memory in 16-byte
// stores.
constexpr int kTcRows = 64;      // rows a block: one warpgroup's wgmma M
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcStages = 2;     // K/V tiles staged ahead, a ring
constexpr int kTcBK = 32;        // keys a tile: wgmma N of the scores
constexpr int kPSplits = 2;      // bf16 terms of P

// blocks an SM holds: three (at most 168 registers a thread) where the
// accumulator allows, so that one block's softmax overlaps another's
// products
template <int DP>
__host__ __device__ constexpr int tc_blocks_per_sm() {
  return DP > 160 ? 2 : 3;
}
template <int DP>
constexpr int tc_smem_bytes() {  // Q, then the stages' K tiles, V tiles
  return 2 * DP * (kTcRows + 2 * kTcStages * kTcBK);
}

// this thread's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers an asynchronous wgmma reads or writes: kept in place, and no
// access moved across this point
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// wgmma shared-memory descriptor of a no-swizzle canonical layout: start
// address, the byte offset between core matrices adjacent in the leading
// dimension (lbo) and in the other (sbo)
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// wgmma wrappers: the score tile (32 keys) and the head dims (64, 128,
// 160, 256) the tensor-core kernel is instantiated for
// d (64 x 32, f32) (+)= A (64 x 16) B (16 x 32), bf16, both K-major in
// shared memory (descriptors); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64, f32) += A (64 x 16, bf16, in registers: per warp 16
// rows) B (16 x 64, bf16, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const unsigned (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128, f32) += A (64 x 16, bf16, in registers: per warp 16
// rows) B (16 x 128, bf16, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 160, f32) += A (64 x 16, bf16, in registers: per warp 16
// rows) B (16 x 160, bf16, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 256, f32) += A (64 x 16, bf16, in registers: per warp 16
// rows) B (16 x 256, bf16, N-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const unsigned (&a)[4], uint64_t b) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, b);
  else if constexpr (DP == 128)
    wgmma_rs_n128(d, a, b);
  else if constexpr (DP == 160)
    wgmma_rs_n160(d, a, b);
  else
    wgmma_rs_n256(d, a, b);
}

// (x, y) rounded to a bf16 pair (x in the low half), and what is left
__device__ __forceinline__ unsigned split_bf16(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  x -= f.x;  // exact: f.x is x rounded
  y -= f.y;
  return *reinterpret_cast<const unsigned*>(&h);
}

// This thread's row of a (ROWS, DP) bf16 tile in the canonical layout at
// dst: row j = tid % ROWS, copied from src where row_in, else zeros;
// columns past D zeros. The thread takes every kTcThreads / ROWS-th
// 16-byte chunk of its row, so neighbouring threads write neighbouring
// 16 bytes of shared memory. vec: 16-byte cp.async copies (D % 8 == 0
// and every row 16-byte aligned; any readable address stands in for src
// where nothing is read), else element copies.
template <int ROWS, int DP>
__device__ __forceinline__ void stage_row(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          bool row_in,
                                          const __nv_bfloat16* any, int D,
                                          bool vec) {
  constexpr int kStreams = kTcThreads / ROWS;  // threads a row
  static_assert(kTcThreads % ROWS == 0 && (DP / 8) % kStreams == 0,
                "whole chunks a thread");
  const int tid = threadIdx.x, j = tid % ROWS;
  if (vec) {
#pragma unroll
    for (int c = tid / ROWS; c < DP / 8; c += kStreams) {
      const bool in = row_in && c * 8 < D;
      cp_async16_zfill(dst + c * ROWS * 16 + j * 16, in ? src + c * 8 : any,
                       in);
    }
  } else {
    for (int d = tid / ROWS; d < DP; d += kStreams)
      reinterpret_cast<__nv_bfloat16*>(dst + (d / 8) * ROWS * 16 +
                                       j * 16)[d % 8] =
          row_in && d < D ? src[d] : __float2bfloat16(0.0f);
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, tc_blocks_per_sm<DP>())
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out,
                const long long* __restrict__ kv_len, int Hq, int group,
                int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
                float scale, float softcap, int causal, int window,
                int vec) {
  // scores go on in base 2 (x log2 e), so the weights are exp2f's: with
  // a cap, x = tanh(s * scale / cap) * cap * log2 e, else s * scale *
  // log2 e
  constexpr float kLog2e = 1.4426950408889634f;
  const float pre = softcap > 0.0f ? scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;
  constexpr int BK = kTcBK;
  constexpr int NF = BK / 8;  // score fragments (8 keys) a tile
  constexpr int NO = DP / 8;  // accumulator fragments (8 columns)
  constexpr int KB = BK * DP * 2;  // bytes of a K or V tile
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* sq = raw;                     // Q: (64, DP)
  unsigned char* sk = sq + kTcRows * DP * 2;   // K: NS x (BK, DP)
  constexpr int NS = kTcStages;
  unsigned char* sv = sk + NS * KB;            // V: NS x (BK, DP)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // late (heavy) rows first
  const int R = group * Tq;
  const int r0 = tile * kTcRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = Tk;
  if (kv_len != nullptr)
    n = static_cast<int>(lmin(lmax(kv_len[b], 0), Tk));
  const int off = n - Tq;  // query i sits at position off + i

  // the block's keys: [kbeg, kend)
  const int rlast = min(r0 + kTcRows, R) - 1;
  int kbeg = 0, kend = n;
  if (causal) kend = min(kend, off + rlast / group + 1);
  if (window > 0) kbeg = max(kbeg, off + r0 / group - window + 1);

  // stage Q: row r of the tile is query (r0 + r) / group of head
  // hk * group + (r0 + r) % group; rows past R are zeros
  {
    const int rr = r0 + tid % kTcRows;
    const bool row_in = rr < R;
    stage_row<kTcRows, DP>(
        sq,
        q + b * qs.b +
            (row_in ? (hk * group + rr % group) * qs.h +
                          static_cast<long long>(rr / group) * qs.t
                    : 0),
        row_in, q, D, vec);
  }
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  // this thread's row of each K/V tile: key j0 + kj of the tile at j0
  const int kj = tid % BK;
  const auto stage_kv = [&](int st, int j0) {
    const bool in = j0 + kj < kend;
    const long long key = in ? j0 + kj : 0;
    stage_row<BK, DP>(sk + st * KB, kb + key * ks.t, in, k, D, vec);
    stage_row<BK, DP>(sv + st * KB, vb + key * vs.t, in, v, D, vec);
  };
  // the first NS - 1 tiles, a commit group each (Q's copies join the
  // first); a group may be empty
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage_kv(t, kbeg + t * BK);
    cp_async_commit();
  }

  // this warp's rows and their positions (the thread's rows g and g + 8)
  const int g = lane >> 2, tig = lane & 3;
  const int wr0 = r0 + warp * 16;
  const bool busy = wr0 < R;
  const int wr1 = min(wr0 + 15, R - 1);
  const int plo = off + wr0 / group, phi = off + wr1 / group;
  int prow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) prow[h] = off + (wr0 + g + 8 * h) / group;

  // descriptors: Q and K K-major (core matrices adjacent along D
  // rows * 16 bytes apart, along rows 128), V N-major for P V (along D
  // BK * 16 bytes apart, along keys 128)
  const unsigned qa = smem_u32(sq), ka = smem_u32(sk), va = smem_u32(sv);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    // tile it + NS - 1 into the stage tile it - 1 left, then wait for
    // tile it (every group but the newest NS - 1 complete)
    if (it + NS - 1 < ntiles)
      stage_kv((it + NS - 1) % NS, k0 + (NS - 1) * BK);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    fence_async_shared();
    __syncthreads();
    const unsigned tk = ka + (it % NS) * KB, tv = va + (it % NS) * KB;

    // S = Q K^T over DP in steps of 16
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wgmma_ss_n32(s,
                   gmma_desc(qa + kd * 2 * kTcRows * 16, kTcRows * 16, 128),
                   gmma_desc(tk + kd * 2 * BK * 16, BK * 16, 128), kd > 0);
    wg_commit();
    wg_wait_all();
    hold(s);

    // scale, soft-cap, mask (only where a bound cuts this warp's rows)
    const bool full = k0 + BK <= kend && (!causal || k0 + BK - 1 <= plo) &&
                      (window <= 0 || k0 > phi - window);
    unsigned vis = 0xffffffffu;  // bit 4 f + e: element e of fragment f
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * f + e] * pre;
        if (softcap > 0.0f) x = tanhf(x) * post;
        if (!full) {
          const int kp = k0 + f * 8 + 2 * tig + (e & 1);
          const int p = prow[e >> 1];
          bool in = kp < kend;
          if (causal) in = in && kp <= p;
          if (window > 0) in = in && kp > p - window;
          if (!in) {
            x = kNegInf;
            vis &= ~(1u << (4 * f + e));
          }
        }
        s[4 * f + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * f + e)) & 1u
                            ? exp2f(s[4 * f + e] - m[e >> 1]) : 0.0f;
        s[4 * f + e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + ls[h];
    // once the rows' maxima settle, alpha is 1 and O needs no rescale
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int f = 0; f < NO; ++f) {
        o[4 * f] *= alpha[0];
        o[4 * f + 1] *= alpha[0];
        o[4 * f + 2] *= alpha[1];
        o[4 * f + 3] *= alpha[1];
      }
    }
    // P as hi + mid + lo in bf16 A fragments, 16 keys a step
    unsigned pa[BK / 16][kPSplits][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float r[4][2] = {{s[8 * kk], s[8 * kk + 1]},
                       {s[8 * kk + 2], s[8 * kk + 3]},
                       {s[8 * kk + 4], s[8 * kk + 5]},
                       {s[8 * kk + 6], s[8 * kk + 7]}};
#pragma unroll
      for (int t = 0; t < kPSplits; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][t][i] = split_bf16(r[i][0], r[i][1]);
    }
    // O += P V
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kPSplits; ++t)
        wgmma_pv<DP>(o, pa[kk][t],
                     gmma_desc(tv + kk * 2 * 128, 128, BK * 16));
    wg_commit();
    wg_wait_all();
    hold(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kPSplits; ++t) hold(pa[kk][t]);
    __syncthreads();  // this stage is refilled NS tiles on
  }
  cp_async_wait<0>();  // Q's copies, where no tile followed
  __syncthreads();     // every copy and product is done: the tiles' space
                       // takes the output

  if (!busy) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / (l[h] + 1e-30f);
  }
  // the warp's 16 output rows, normalised and rounded, go through its own
  // rows of a (kTcRows, DP + 8) staging array over the tiles, then out in
  // 16-byte stores where a row is whole 16 bytes; lane j < 16 finds row
  // j's place in out
  constexpr int SR = DP + 8;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(raw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int f = 0; f < NO; ++f)
      *reinterpret_cast<__nv_bfloat162*>(
          so + (warp * 16 + g + 8 * h) * SR + f * 8 + 2 * tig) =
          __floats2bfloat162_rn(o[4 * f + 2 * h] * inv[h],
                                o[4 * f + 2 * h + 1] * inv[h]);
  }
  __syncwarp();
  const int rl = wr0 + (lane & 15);
  const long long place =
      ((static_cast<long long>(b) * Tq + rl / group) * Hq + hk * group +
       rl % group) * D;
  for (int j = 0; j < 16 && wr0 + j < R; ++j) {
    __nv_bfloat16* dst = out + __shfl_sync(0xffffffffu, place, j);
    const __nv_bfloat16* row = so + (warp * 16 + j) * SR;
    if (D % 8 == 0) {
      for (int c = lane * 8; c < D; c += 32 * 8)
        *reinterpret_cast<uint4*>(dst + c) =
            *reinterpret_cast<const uint4*>(row + c);
    } else {
      for (int d = lane; d < D; d += 32) dst[d] = row[d];
    }
  }
}

// Tq <= kDecodeTq (decode), either dtype: the keys of a (key head, batch
// row) split across a thread-block cluster. Grid (splits, Hkv * chunks,
// B), cluster (splits, 1, 1) where splits > 1: a block holds `rows` =
// min(group * Tq, dec_rows) query rows of its key head (more rows than
// that take further chunks of grid y), so one K/V tile serves the group.
// The block's visible keys [kbeg, kend) (kv_len, the causal bound and
// the window of its rows) are cut into tiles (16 keys in bf16, 32 in
// f32) and dealt out in turn: tile t to split t % splits, and within the
// split to warp (t / splits) % nw, so splits and warps get shares that
// differ by at most one tile and a split may see none. Each warp streams
// its tiles through its own ring of ns stages: a bulk copy (TMA) a K or V
// row, one row a lane, completing on the stage's mbarrier, where rows
// are 16-byte aligned, else element copies; the first tiles go out
// before q is staged, and the next tile is in flight while this one is
// worked. K and V rows are padded to an odd number of 16 bytes, so that
// 8 rows' 16-byte reads fall in distinct banks. bf16 runs the products
// on the tensor cores with the keys as the M dimension: S^T (16 keys x 8
// rows) = K Q^T (mma.sync m16n8k16, K by ldmatrix, Q^T in registers),
// the softmax on the accumulators in base 2 (each thread holds two rows,
// a row's maximum over the lanes of its column), P^T carried as two bf16
// terms (hi + lo: one term errs by 2^-9 of a weight, more than the bf16
// output's check leaves) and transposed in registers (movmatrix) into
// the B operand of O^T (D x 8 rows) += V^T P^T (V by ldmatrix.trans).
// f32 runs on the f32 units: lane j scores key j against every row (q
// broadcast from shared memory), keeps its share of each row's sum,
// writes its weights to shared memory, and the lanes split D in column
// pairs for P V. At the end the warps' states merge in shared memory:
// with one split straight into the output, else into the split's state,
// after which the cluster syncs, each row's factor of each split is
// computed once, and block `rank` merges its slice of the rows' outputs
// over the splits' states (read through distributed shared memory) in
// split order; a second cluster barrier keeps every state alive until
// all blocks have read it.
constexpr int kDecMaxWarps = 8;
constexpr int kDecMaxStages = 3;
constexpr int kDecMaxSplits = 8;   // cluster size: the portable limit
constexpr int kDecBarBytes = 8 * kDecMaxWarps * kDecMaxStages;

// keys a warp's tile: the mma's M (16) in bf16, one a lane (32) in f32
template <typename T>
__host__ __device__ constexpr int dec_keys() {
  return std::is_same_v<T, __nv_bfloat16> ? 16 : 32;
}

// query rows a decode block holds at most: 8 (the mma's N) in bf16; 4
// in f32, whose lanes work every row against their key in turn (more
// rows a block lengthen that chain more than they save K/V reads)
template <typename T, int DP>
__host__ __device__ constexpr int dec_rows() {
  return std::is_same_v<T, __nv_bfloat16> ? 8 : 4;
}

// shared memory of the decode kernel: q rows (f32), the split's merged
// state (acc, m, l: f32, read by the cluster), then for each warp a ring
// of ns K/V tiles (T) and, in f32, its tile's weights; at the end the
// merge area (the warps' acc, m, l and the splits' factors, f32) is laid
// over the rings
struct DecLayout {
  int dp;     // D rounded up: to 16 elements in bf16, 16 bytes in f32
  int kst;    // K and V row stride (elements): an odd number of 16 bytes
  int rows;   // query rows a block holds
  int nw;     // warps
  int ns;     // ring stages a warp
  int bytes;  // dynamic shared memory
};

template <typename T>
__host__ __device__ int dec_stage_elems(const DecLayout& L) {
  return 2 * dec_keys<T>() * L.kst;  // one K tile, then one V tile
}
template <typename T>
__host__ __device__ int dec_warp_bytes(const DecLayout& L) {
  return L.ns * dec_stage_elems<T>(L) * static_cast<int>(sizeof(T)) +
         (std::is_same_v<T, float> ? L.rows * dec_keys<T>() * 4 : 0);
}
__host__ __device__ inline int dec_fixed_bytes(const DecLayout& L) {
  return (kDecBarBytes + 4 * (2 * L.rows * L.dp + 2 * L.rows) + 15) / 16 *
         16;
}
__host__ __device__ inline int dec_merge_bytes(const DecLayout& L) {
  return 4 * (L.nw * L.rows * L.dp + 2 * L.nw * L.rows +
              L.rows * kDecMaxSplits);
}

// four 8 x 8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; a thread gets (row g, columns 2 tig, 2 tig
// + 1) of each (plain) or of each one's transpose (trans)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// the transpose of an 8 x 8 b16 matrix held a pair a lane
__device__ __forceinline__ unsigned movm_t(unsigned x) {
  unsigned y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// mbarriers and bulk copies (TMA without a tensor map) of the decode ring
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T, int DP>
__global__ void __launch_bounds__(kDecMaxWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    const long long* __restrict__ kv_len, int Hq, int group,
                    int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
                    float scale, float softcap, int causal, int window,
                    DecLayout lay, int vec) {
  constexpr bool kTC = std::is_same_v<T, __nv_bfloat16>;
  constexpr int RB = dec_rows<T, DP>();
  constexpr int NPC = (DP + 63) / 64;  // f32: column pairs 2 lane + 64 c
  constexpr int NDT = DP / 16;         // bf16: 16-column tiles of O^T
  constexpr int KT = dec_keys<T>();
  // bf16 keeps scores in base 2 (x log2 e) and takes exp2f; f32 expf
  const auto ex = [](float x) { return kTC ? exp2f(x) : expf(x); };
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(gridDim.x);  // the cluster's blocks
  const int split = static_cast<int>(cluster.block_rank());
  const int dp = lay.dp, kst = lay.kst, nw = lay.nw, ns = lay.ns;
  const int rows = lay.rows;
  const int R = group * Tq;  // query rows of a key head
  const int chunks = (R + rows - 1) / rows;
  const int hk = blockIdx.y / chunks;
  const int r0 = (blockIdx.y % chunks) * rows;
  const int nr = min(rows, R - r0);  // this block's rows
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nthr = nw * 32;

  extern __shared__ __align__(16) unsigned char raw[];
  const unsigned bars = smem_u32(raw);  // [warp][stage] mbarriers
  float* sq = reinterpret_cast<float*>(raw + kDecBarBytes);  // [rows][dp]
  float* st_a = sq + rows * dp;                              // [rows][dp]
  float* st_m = st_a + rows * dp;                            // [rows]
  float* st_l = st_m + rows;                                 // [rows]
  unsigned char* wbase = raw + dec_fixed_bytes(lay);
  const int se = dec_stage_elems<T>(lay);
  T* ring = reinterpret_cast<T*>(wbase + warp * dec_warp_bytes<T>(lay));
  float* sp = reinterpret_cast<float*>(ring + ns * se);  // f32: [rows][32]
  const unsigned bar = bars + 8 * warp * kDecMaxStages;  // this warp's

  // the warp's barriers, before any load is in flight (the init's
  // release fence then waits for nothing)
  if (vec) {
    if (lane < ns) mbar_init(bar + 8 * lane);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // q's elements e0, e0 + nthr, ... (eight) into xq; the first eight go
  // out with kv_len, so the two loads overlap
  float xq[8];
  const auto load_q = [&](int e0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * nthr, r = e / dp, d = e % dp, rr = r0 + r;
      xq[u] = e < rows * dp && r < nr && d < D
                  ? to_f(q[b * qs.b + (hk * group + rr % group) * qs.h +
                           static_cast<long long>(rr / group) * qs.t + d])
                  : 0.0f;
    }
  };
  load_q(tid);
  int n = Tk;
  if (kv_len != nullptr)
    n = static_cast<int>(lmin(lmax(kv_len[b], 0), Tk));
  const int off = n - Tq;  // query i sits at position off + i
  int kbeg = 0, kend = n;
  if (causal) kend = min(kend, off + (r0 + nr - 1) / group + 1);
  if (window > 0) kbeg = max(kbeg, off + r0 / group - window + 1);
  const int tiles = kend > kbeg ? (kend - kbeg + KT - 1) / KT : 0;
  // this warp's tiles: unit, unit + step, ...
  const int unit = split + splits * warp, step = splits * nw;
  const int mine = tiles > unit ? (tiles - unit + step - 1) / step : 0;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  // the first key of this warp's i-th tile
  const auto tile_k0 = [&](int i) { return kbeg + (unit + i * step) * KT; };
  // tile i into its stage (K rows, then V rows): a bulk copy a row, one
  // row a lane, where rows are 16-byte aligned, else element copies.
  // Rows past kend are zeros, each written by the lane that copies the
  // row, which fences them off from its later copies; the reads of a
  // stage are done, at the warp's barrier, before it is refilled.
  const auto stage = [&](int i) {
    const int k0 = tile_k0(i), nk = min(KT, kend - k0), st = i % ns;
    T* sk = ring + st * se;
    if (vec) {
      const unsigned row_bytes = D * static_cast<unsigned>(sizeof(T));
      if (lane == 0) mbar_expect(bar + 8 * st, 2u * nk * row_bytes);
      for (int j = lane; j < 2 * KT; j += 32) {
        const int row = j % KT;
        T* dst = sk + (j / KT) * KT * kst + row * kst;
        if (row < nk) {
          bulk_copy(dst,
                    j < KT ? kb + static_cast<long long>(k0 + row) * ks.t
                           : vb + static_cast<long long>(k0 + row) * vs.t,
                    row_bytes, bar + 8 * st);
        } else {
          for (int c = 0; c < dp; c += vec_elems<T>())
            *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
          fence_async_shared();
        }
      }
    } else {
      T* sv = sk + KT * kst;
      for (int e = lane; e < KT * dp; e += 32) {
        const int j = e / dp, d = e % dp;
        const bool in = j < nk && d < D;
        const long long key = k0 + j;
        sk[j * kst + d] = in ? kb[key * ks.t + d] : from_f<T>(0.0f);
        sv[j * kst + d] = in ? vb[key * vs.t + d] : from_f<T>(0.0f);
      }
    }
  };

  // the warp's first tiles in flight (they need no q), then q: the
  // copies and q's loads overlap
  if (vec && D < dp) {
    // bulk copies write D columns of a row: the columns past D, zeros,
    // are written once here
    for (int e = lane; e < ns * 2 * KT * (dp - D); e += 32)
      ring[(e / (dp - D)) * kst + D + e % (dp - D)] = from_f<T>(0.0f);
    fence_async_shared();
  }
  __syncwarp();
  for (int i = 0; i < ns - 1 && i < mine; ++i) stage(i);
  // q, eight loads in flight a thread (the first eight loaded above)
  for (int e0 = tid; e0 < rows * dp; e0 += 8 * nthr) {
    if (e0 != tid) load_q(e0);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * nthr < rows * dp) sq[e0 + u * nthr] = xq[u];
  }
  __syncthreads();

  // bf16: m, l of the thread's rows 2 tig and 2 tig + 1 (l its share of
  // the row's sum), O^T tiles o[dt] (columns 16 dt + g (+ 8) of those
  // rows) and Q^T fragments in registers; f32: m, l (the lane's share)
  // of every row, acc[r] the lane's column pairs
  constexpr int NM = kTC ? 2 : RB;
  float m[NM], l[NM];
#pragma unroll
  for (int r = 0; r < NM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }
  float acc[kTC ? 1 : RB][2 * NPC];
  float o[kTC ? NDT : 1][4];
  unsigned qf[kTC ? NDT : 1][2];
  int pos[2] = {0, 0};  // bf16: the positions of rows 2 tig, 2 tig + 1
  // bf16: scores x log2 e, soft-capped as tanh(s pre) post
  constexpr float kLog2e = 1.4426950408889634f;
  const float pre = softcap > 0.0f ? scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;
  if constexpr (kTC) {
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
      const float* qr = sq + g * dp + 16 * dt + 2 * tig;
      const bool in = g < rows && 16 * dt < dp;
      qf[dt][0] = in ? pack_bf16(qr[0], qr[1]) : 0u;
      qf[dt][1] = in ? pack_bf16(qr[8], qr[9]) : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) pos[h] = off + (r0 + 2 * tig + h) / group;
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 2 * NPC; ++c) acc[r][c] = 0.0f;
  }

  for (int it = 0; it < mine; ++it) {
    // tile it + ns - 1 into the stage tile it - 1 left, then wait for
    // tile it (its stage's (it / ns)-th use)
    if (it + ns - 1 < mine) stage(it + ns - 1);
    if (vec) mbar_wait(bar + 8 * (it % ns), (it / ns) & 1);
    __syncwarp();
    const int k0 = tile_k0(it), nk = min(KT, kend - k0);
    const T* sk = ring + (it % ns) * se;
    const T* sv = sk + KT * kst;

    if constexpr (kTC) {
      // S^T = K Q^T: s keys g (+ 8) of rows 2 tig (+ 1), the 16-column
      // steps of D summed in two accumulators by parity
      const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        if (16 * dt >= dp) break;
        unsigned a[4];
        ldsm_x4(a, sk + ((lane & 7) + 8 * (mi & 1)) * kst + 16 * dt +
                       8 * (mi >> 1));
        mma_bf16(s[dt & 1], a, qf[dt][0], qf[dt][1]);
      }
      // scale, soft-cap, mask; the rows' maxima over the tile
      unsigned vis = 0;  // bit e: accumulator e
      float x[4], mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = g + 8 * (e >> 1), h = e & 1;
        const int kp = k0 + j;
        bool in = j < nk && 2 * tig + h < nr;
        if (causal) in = in && kp <= pos[h];
        if (window > 0) in = in && kp > pos[h] - window;
        float y = (s[0][e] + s[1][e]) * pre;
        if (softcap > 0.0f) y = tanhf(y) * post;
        x[e] = in ? y : kNegInf;
        vis |= in ? 1u << e : 0u;
        mx[h] = fmaxf(mx[h], x[e]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o2 = 4; o2 < 32; o2 <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o2));
        alpha[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = (vis >> e) & 1u ? exp2f(x[e] - m[e & 1]) : 0.0f;
        l[e & 1] += x[e];
      }
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e & 1];
      // P^T as hi + lo bf16 pairs (key g of rows 2 tig, 2 tig + 1),
      // transposed into P's B fragments (row g of keys 2 tig, 2 tig + 1)
      unsigned ph[2], pl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = x[2 * h], y1 = x[2 * h + 1];
        ph[h] = movm_t(split_bf16(y0, y1));
        pl[h] = movm_t(pack_bf16(y0, y1));
      }
      // O^T += V^T P^T
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        if (16 * dt >= dp) break;
        unsigned a[4];
        ldsm_x4_t(a, sv + ((lane & 7) + 8 * (mi >> 1)) * kst + 16 * dt +
                         8 * (mi & 1));
        mma_bf16(o[dt], a, pl[0], pl[1]);
        mma_bf16(o[dt], a, ph[0], ph[1]);
      }
    } else {
      // scores: lane j takes key k0 + j against every row
      constexpr int kVE = vec_elems<T>();
      float s[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = 0.0f;
      if (lane < nk) {
        const T* kr = sk + lane * kst;
        for (int d = 0; d < dp; d += kVE) {
          float kd[kVE];
          unpack16(kr + d, kd);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r >= nr) break;
#pragma unroll
            for (int e = 0; e < kVE; e += 4) {
              float qd[4];
              unpack16(sq + r * dp + d + e, qd);
#pragma unroll
              for (int u = 0; u < 4; ++u)
                s[r] = fmaf(qd[u], kd[e + u], s[r]);
            }
          }
        }
      }
      const int kp = k0 + lane;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) break;
        const int p = off + (r0 + r) / group;
        float x = s[r] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool in = lane < nk;
        if (causal) in = in && kp <= p;
        if (window > 0) in = in && kp > p - window;
        x = in ? x : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float w = in ? expf(x - m_new) : 0.0f;
        const float alpha = expf(m[r] - m_new);
        l[r] = fmaf(alpha, l[r], w);
        m[r] = m_new;
        sp[r * KT + lane] = w;
#pragma unroll
        for (int c = 0; c < 2 * NPC; ++c) acc[r][c] *= alpha;
      }
      __syncwarp();
      // P V: lane owns columns 2 lane + 64 c and the next, four keys a
      // step (keys past nk have weight 0 and zero rows)
      for (int j = 0; j < nk; j += 4) {
        float vv[4][2 * NPC];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < NPC; ++c) {
            const int d = 2 * lane + 64 * c;
            const float2 f = d < dp ? load2(sv + (j + u) * kst + d)
                                    : make_float2(0.0f, 0.0f);
            vv[u][2 * c] = f.x;
            vv[u][2 * c + 1] = f.y;
          }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r >= nr) break;
          const float4 p4 =
              *reinterpret_cast<const float4*>(sp + r * KT + j);
#pragma unroll
          for (int c = 0; c < 2 * NPC; ++c) {
            float a = acc[r][c];
            a = fmaf(p4.x, vv[0][c], a);
            a = fmaf(p4.y, vv[1][c], a);
            a = fmaf(p4.z, vv[2][c], a);
            a = fmaf(p4.w, vv[3][c], a);
            acc[r][c] = a;
          }
        }
      }
    }
    __syncwarp();  // the stage (and the weights) are free again
  }

  // the warps' states over the rings: acc, then m, then l
  __syncthreads();
  float* wa = reinterpret_cast<float*>(wbase);  // [nw][rows][dp]
  float* wm = wa + nw * rows * dp;              // [nw][rows]
  float* wl = wm + nw * rows;                   // [nw][rows]
  float* sc = wl + nw * rows;                   // [rows][splits]
  if constexpr (kTC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], o2);
      const int r = 2 * tig + h;
      if (r < nr) {
        if (g == 0) {
          wm[warp * rows + r] = m[h];
          wl[warp * rows + r] = l[h];
        }
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 16 * dt + g + 8 * e;
            if (d < dp) wa[(warp * rows + r) * dp + d] = o[dt][2 * e + h];
          }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= nr) break;
      l[r] = warp_sum(l[r]);
      if (lane == 0) {
        wm[warp * rows + r] = m[r];
        wl[warp * rows + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < NPC; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < dp)
          *reinterpret_cast<float2*>(wa + (warp * rows + r) * dp + d) =
              make_float2(acc[r][2 * c], acc[r][2 * c + 1]);
      }
    }
  }
  __syncthreads();
  const int q4 = dp / 4;  // four columns a thread
  // out = sum_w e^(m_w - M) acc_w / (sum_w e^(m_w - M) l_w + 1e-30), M
  // the largest m_w; a warp (or a split) that saw no key holds m =
  // kNegInf, l = 0, acc = 0 and adds nothing (or, if none saw one, 0 /
  // 1e-30)
  const auto store = [&](int r, int c, float4 a, float den) {
    const int rr = r0 + r;
    T* dst = out + ((static_cast<long long>(b) * Tq + rr / group) * Hq +
                    hk * group + rr % group) * D;
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < D) dst[c + u] = from_f<T>(av[u] / den);
  };
  if (splits == 1) {  // one split: the warps' merge is the output
    for (int e = tid; e < nr * q4; e += nthr) {
      const int r = e / q4, c = (e % q4) * 4;
      float mw[kDecMaxWarps], M = kNegInf;
#pragma unroll
      for (int i = 0; i < kDecMaxWarps; ++i) {  // all loads in flight
        mw[i] = i < nw ? wm[i * rows + r] : kNegInf;
        M = fmaxf(M, mw[i]);
      }
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float L = 0.0f;
#pragma unroll
      for (int i = 0; i < kDecMaxWarps; ++i) {
        const int w = i < nw ? i : nw - 1;
        const float f = i < nw ? ex(mw[i] - M) : 0.0f;
        const float4 x =
            *reinterpret_cast<const float4*>(wa + (w * rows + r) * dp + c);
        L = fmaf(f, wl[w * rows + r], L);
        a.x = fmaf(f, x.x, a.x);
        a.y = fmaf(f, x.y, a.y);
        a.z = fmaf(f, x.z, a.z);
        a.w = fmaf(f, x.w, a.w);
      }
      store(r, c, a, L + 1e-30f);
    }
    return;
  }
  // more splits: each row's factors over the warps, e^(m_w - M) in place
  // of m_w, and the split's (M, L), a row a warp
  for (int r = warp; r < nr; r += nw) {
    const float mw = lane < nw ? wm[lane * rows + r] : kNegInf;
    const float M = warp_max(mw);
    const float f = lane < nw ? ex(mw - M) : 0.0f;
    const float L = warp_sum(lane < nw ? f * wl[lane * rows + r] : 0.0f);
    if (lane < nw) wm[lane * rows + r] = f;
    if (lane == 0) {
      st_m[r] = M;
      st_l[r] = L;
    }
  }
  __syncthreads();
  const auto merge_warps = [&](int r, int c) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kDecMaxWarps; ++i) {  // all loads in flight
      const int w = i < nw ? i : nw - 1;
      const float f = i < nw ? wm[w * rows + r] : 0.0f;
      const float4 x =
          *reinterpret_cast<const float4*>(wa + (w * rows + r) * dp + c);
      a.x = fmaf(f, x.x, a.x);
      a.y = fmaf(f, x.y, a.y);
      a.z = fmaf(f, x.z, a.z);
      a.w = fmaf(f, x.w, a.w);
    }
    return a;
  };
  for (int e = tid; e < nr * q4; e += nthr) {
    const int r = e / q4, c = (e % q4) * 4;
    *reinterpret_cast<float4*>(st_a + r * dp + c) = merge_warps(r, c);
  }
  cluster.sync();  // every split's state is in its shared memory

  // each row's factor of each split, e^(M_s - M) / L with L the sum of
  // e^(M_s - M) L_s, a row a warp, lane s reading split s
  for (int r = warp; r < nr; r += nw) {
    const float ms = lane < splits ? *cluster.map_shared_rank(st_m + r, lane)
                                   : kNegInf;
    const float M = warp_max(ms);
    const float f = lane < splits ? ex(ms - M) : 0.0f;
    const float L = warp_sum(
        lane < splits ? f * *cluster.map_shared_rank(st_l + r, lane) : 0.0f);
    if (lane < splits) sc[r * splits + lane] = f / (L + 1e-30f);
  }
  __syncthreads();
  // this block's slice of the rows' outputs, merged in split order
  const int total = nr * q4;
  const int slice = (total + splits - 1) / splits;
  const int e1 = min(total, (split + 1) * slice);
  for (int e = split * slice + tid; e < e1; e += nthr) {
    const int r = e / q4, c = (e % q4) * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < kDecMaxSplits; ++s) {
      if (s >= splits) break;
      const float f = sc[r * splits + s];
      const float4 x = *cluster.map_shared_rank(
          reinterpret_cast<float4*>(st_a + r * dp + c), s);
      a.x = fmaf(f, x.x, a.x);
      a.y = fmaf(f, x.y, a.y);
      a.z = fmaf(f, x.z, a.z);
      a.w = fmaf(f, x.w, a.w);
    }
    store(r, c, a, 1.0f);
  }
  cluster.sync();  // no block leaves while another reads its state
}

// Tq > kDecodeTq in f32 (prefill): products on the tensor cores in
// 3xTF32. A block of 4 warps takes kF32Rows = 16 rows of the row space
// of one (key head, batch row), packed as in flash_tc_kernel, and its
// warps split each 32-key tile: warp w takes keys 8 w to 8 w + 7 for all
// 16 rows, with a running (m, l, acc) of its own, and the four states
// merge through shared memory at the end. Q is staged once and split in
// shared memory into TF32 hi and lo terms (each element once, not once a
// warp and tile); K/V tiles are staged by 16-byte cp.async copies by the
// whole block (zeros past the keys and past D), kF32Stages deep, rows
// padded to DP + 4 floats so that every fragment load below falls in 32
// distinct banks. Per tile a warp computes its 16 x 8 scores with
// mma.sync m16n8k8 (A = Q's terms, B = K rows split as they load), the
// hi hi and the two small products in accumulators of their own and each
// in two by the parity of the 8-column step (short dependency chains),
// soft-caps and masks them in registers, updates each row's running max
// and sum with quad shuffles, and adds P V to its 16 x DP f32
// accumulator with the score registers as the A operand: the
// accumulator gives a thread keys 2 tig and 2 tig + 1, where A wants
// keys tig and tig + 4, so the keys are taken in the order (0, 2, 4, 6,
// 1, 3, 5, 7) and V's rows are read in the same order (B row tig is key
// 2 tig, row tig + 4 key 2 tig + 1). The row tiles launch last-first, so
// the causal rows that see the most keys start first.
constexpr int kF32Rows = 16;    // rows a block: one m16 tile
constexpr int kF32Warps = 4;    // warps a block: 8 keys of a tile each
constexpr int kF32BK = 8 * kF32Warps;  // keys a tile
constexpr int kF32Stages = 2;   // K/V tiles staged ahead, a ring

template <int DP>
constexpr int tf32_smem_bytes() {  // Q's two terms, then the K, V tiles
  return 4 * (DP + 4) * (2 * kF32Rows + 2 * kF32Stages * kF32BK);
}

// x as a TF32 high term (x cut to TF32's 10 fraction bits) and what is
// left (exact in f32, |lo| < 2^-10 |x|), whose low 13 bits the tensor
// core does not read: lo keeps its top 11 bits, so hi + lo is x to
// about 2^-21 of |x|
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8, f32) += a (16 x 8, TF32, row) b (8 x 8, TF32, col)
__device__ __forceinline__ void mma_tf32(float* d, const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int DP>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  const long long* __restrict__ kv_len, int Hq, int group,
                  int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
                  float scale, float softcap, int causal, int window,
                  int vec) {
  constexpr int S = DP + 4;  // row stride in shared memory (floats)
  constexpr int BK = kF32BK, NS = kF32Stages, RW = kF32Rows;
  constexpr int NO = DP / 8;  // accumulator fragments (8 columns)
  constexpr int C4 = DP / 4;  // 16-byte pieces a row
  constexpr int nthr = kF32Warps * 32;
  extern __shared__ __align__(16) float fsm[];
  float* sq = fsm;               // Q: (RW, S), then its hi terms
  float* sql = sq + RW * S;      // Q's lo terms: (RW, S)
  float* skv = sql + RW * S;     // NS x (K (BK, S), V (BK, S))

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // late (heavy) rows first
  const int R = group * Tq;
  const int r0 = tile * RW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  int n = Tk;
  if (kv_len != nullptr)
    n = static_cast<int>(lmin(lmax(kv_len[b], 0), Tk));
  const int off = n - Tq;  // query i sits at position off + i

  // the block's keys: [kbeg, kend)
  const int rlast = min(r0 + RW, R) - 1;
  int kbeg = 0, kend = n;
  if (causal) kend = min(kend, off + rlast / group + 1);
  if (window > 0) kbeg = max(kbeg, off + r0 / group - window + 1);

  // stage Q: row r of the tile is query (r0 + r) / group of head
  // hk * group + (r0 + r) % group; rows past R and columns past D zeros
  for (int e = tid; e < RW * C4; e += nthr) {
    const int r = e / C4, c = e % C4, rr = r0 + r;
    const bool row_in = rr < R;
    const float* src =
        q + b * qs.b +
        (row_in ? (hk * group + rr % group) * qs.h +
                      static_cast<long long>(rr / group) * qs.t
                : 0);
    if (vec) {
      const bool in = row_in && c * 4 < D;
      cp_async16_zfill(sq + r * S + c * 4, in ? src + c * 4 : q, in);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = c * 4 + u;
        sq[r * S + d] = row_in && d < D ? src[d] : 0.0f;
      }
    }
  }
  cp_async_commit();
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const auto stage_kv = [&](int st, int j0) {
    float* sk = skv + st * 2 * BK * S;
    float* sv = sk + BK * S;
    for (int e = tid; e < BK * C4; e += nthr) {
      const int j = e / C4, c = e % C4;
      const bool row_in = j0 + j < kend;
      const long long key = row_in ? j0 + j : 0;
      if (vec) {
        const bool in = row_in && c * 4 < D;
        cp_async16_zfill(sk + j * S + c * 4, in ? kb + key * ks.t + c * 4 : k,
                         in);
        cp_async16_zfill(sv + j * S + c * 4, in ? vb + key * vs.t + c * 4 : v,
                         in);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = c * 4 + u;
          const bool in = row_in && d < D;
          sk[j * S + d] = in ? kb[key * ks.t + d] : 0.0f;
          sv[j * S + d] = in ? vb[key * vs.t + d] : 0.0f;
        }
      }
    }
  };
  // the first NS - 1 tiles, a commit group each; a group may be empty
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage_kv(t, kbeg + t * BK);
    cp_async_commit();
  }
  // Q split in place into hi (sq) and lo (sql), once
  cp_async_wait<NS - 1>();
  __syncthreads();
  for (int e = tid; e < RW * S; e += nthr) {
    unsigned hi, lo;
    split_tf32(sq[e], hi, lo);
    sq[e] = __uint_as_float(hi);
    sql[e] = __uint_as_float(lo);
  }

  // the thread's rows g and g + 8 and their positions
  const int plo = off + r0 / group, phi = off + rlast / group;
  int prow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) prow[h] = off + (r0 + g + 8 * h) / group;
  const unsigned* qh = reinterpret_cast<const unsigned*>(sq);
  const unsigned* ql = reinterpret_cast<const unsigned*>(sql);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    // tile it + NS - 1 into the stage tile it - 1 left, then wait for
    // tile it (every group but the newest NS - 1 complete)
    if (it + NS - 1 < ntiles)
      stage_kv((it + NS - 1) % NS, k0 + (NS - 1) * BK);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const float* sk = skv + (it % NS) * 2 * BK * S + 8 * warp * S;
    const float* sv = sk + BK * S;  // this warp's 8 keys of K and V
    const int kw = k0 + 8 * warp;    // their first key

    if (kw < kend) {
      // S = Q K^T over D in steps of 8: acc[t][p] holds term t (hi hi,
      // lo hi, hi lo) of the steps of parity p
      float acc[3][2][4];
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][p][e] = 0.0f;
#pragma unroll 2
      for (int kd = 0; kd < DP; kd += 16) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c = kd + 8 * p;
          if (c >= D) break;
          const int i0 = g * S + c + tig, i1 = (g + 8) * S + c + tig;
          const unsigned ah[4] = {qh[i0], qh[i1], qh[i0 + 4], qh[i1 + 4]};
          const unsigned al[4] = {ql[i0], ql[i1], ql[i0 + 4], ql[i1 + 4]};
          const float* kr = sk + g * S + c + tig;
          unsigned bh[2], bl[2];
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_tf32(acc[0][p], ah, bh);
          mma_tf32(acc[1][p], al, bh);
          mma_tf32(acc[2][p], ah, bl);
        }
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = (acc[1][0][e] + acc[1][1][e] + acc[2][0][e] + acc[2][1][e]) +
               (acc[0][0][e] + acc[0][1][e]);

      // scale, soft-cap, mask (only where a bound cuts these keys)
      const bool full = kw + 8 <= kend && (!causal || kw + 7 <= plo) &&
                        (window <= 0 || kw > phi - window);
      unsigned vis = 0xfu;  // bit e: element e
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[e] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (!full) {
          const int kp = kw + 2 * tig + (e & 1);
          const int p = prow[e >> 1];
          bool in = kp < kend;
          if (causal) in = in && kp <= p;
          if (window > 0) in = in && kp > p - window;
          if (!in) {
            x = kNegInf;
            vis &= ~(1u << e);
          }
        }
        s[e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> e) & 1u ? expf(s[e] - m[e >> 1]) : 0.0f;
        s[e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
      for (int f = 0; f < NO; ++f) {
        o[4 * f] *= alpha[0];
        o[4 * f + 1] *= alpha[0];
        o[4 * f + 2] *= alpha[1];
        o[4 * f + 3] *= alpha[1];
      }

      // O += P V over the 8 keys, in the order (0, 2, 4, 6, 1, 3, 5, 7)
      unsigned ph[4], pl[4];
      split_tf32(s[0], ph[0], pl[0]);  // row g, key 2 tig
      split_tf32(s[2], ph[1], pl[1]);  // row g + 8, key 2 tig
      split_tf32(s[1], ph[2], pl[2]);  // row g, key 2 tig + 1
      split_tf32(s[3], ph[3], pl[3]);  // row g + 8, key 2 tig + 1
      const float* v0 = sv + 2 * tig * S + g;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        if (nt * 8 >= D) break;
        unsigned bh[2], bl[2];
        split_tf32(v0[nt * 8], bh[0], bl[0]);
        split_tf32(v0[S + nt * 8], bh[1], bl[1]);
        mma_tf32(o + 4 * nt, pl, bh);
        mma_tf32(o + 4 * nt, ph, bl);
        mma_tf32(o + 4 * nt, ph, bh);
      }
    }
    __syncthreads();  // this stage is refilled NS tiles on
  }
  cp_async_wait<0>();

  // the warps' states, over the K/V tiles: out = sum_w e^(m_w - M) o_w /
  // (sum_w e^(m_w - M) l_w + 1e-30), M the largest m_w (a warp that saw
  // no key adds nothing)
  float* wo = skv;                      // [warp][16][S]
  float* wm = wo + kF32Warps * RW * S;  // [warp][16]
  float* wl = wm + kF32Warps * RW;      // [warp][16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = g + 8 * h;
    if (tig == 0) {
      wm[warp * RW + r] = m[h];
      wl[warp * RW + r] = l[h];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      float* dst = wo + (warp * RW + r) * S + nt * 8 + 2 * tig;
      dst[0] = o[4 * nt + 2 * h];
      dst[1] = o[4 * nt + 2 * h + 1];
    }
  }
  __syncthreads();
  for (int e = tid; e < RW * D; e += nthr) {
    const int r = e / D, d = e % D, rr = r0 + r;
    if (rr >= R) break;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) M = fmaxf(M, wm[w * RW + r]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float f = expf(wm[w * RW + r] - M);
      L = fmaf(f, wl[w * RW + r], L);
      A = fmaf(f, wo[(w * RW + r) * S + d], A);
    }
    out[((static_cast<long long>(b) * Tq + rr / group) * Hq + hk * group +
         rr % group) * D + d] = A / (L + 1e-30f);
  }
}

// a call's arguments, as the entry points take them
struct Args {
  const void *q, *k, *v;
  void* out;
  const void* kv_len;
  int B, Hq, Hkv, Tq, Tk, D;
  Strides qs, ks, vs;
  float scale, softcap;
  int causal, window, splits;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}
// whether every row of x (base and strides in elements) is 16-byte aligned
bool rows16(const void* p, const Strides& s, long long elems) {
  return aligned16(p) && s.b % elems == 0 && s.h % elems == 0 &&
         s.t % elems == 0;
}

template <int DP>
int launch_tc(const Args& a) {
  constexpr int bytes = tc_smem_bytes<DP>();
  auto* kernel = flash_tc_kernel<DP>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const long long tiles =
      (static_cast<long long>(a.Hq / a.Hkv) * a.Tq + kTcRows - 1) / kTcRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  // 16-byte copies need D whole 16 bytes and every row 16-byte aligned
  const bool vec = a.D % 8 == 0 && rows16(a.q, a.qs, 8) &&
                   rows16(a.k, a.ks, 8) && rows16(a.v, a.vs, 8);
  kernel<<<dim3(a.Hkv, a.B, static_cast<unsigned>(tiles)), kTcThreads, bytes,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out),
      static_cast<const long long*>(a.kv_len), a.Hq, a.Hq / a.Hkv, a.Tq,
      a.Tk, a.D, a.qs, a.ks, a.vs, a.scale, a.softcap, a.causal, a.window,
      vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_tf32(const Args& a) {
  constexpr int kMaxBytes = tf32_smem_bytes<DP>();
  auto* kernel = flash_tf32_kernel<DP>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const long long tiles =
      (static_cast<long long>(a.Hq / a.Hkv) * a.Tq + kF32Rows - 1) / kF32Rows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const bool vec = a.D % 4 == 0 && rows16(a.q, a.qs, 4) &&
                   rows16(a.k, a.ks, 4) && rows16(a.v, a.vs, 4);
  kernel<<<dim3(a.Hkv, a.B, static_cast<unsigned>(tiles)), kF32Warps * 32,
           kMaxBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<const long long*>(a.kv_len), a.Hq, a.Hq / a.Hkv, a.Tq,
      a.Tk, a.D, a.qs, a.ks, a.vs, a.scale, a.softcap, a.causal, a.window,
      vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// whether `clusters` clusters of `splits` blocks of the decode kernel
// at `bytes` of shared memory and `threads` threads all run at once (the
// card's answer, kept per shape)
template <typename K>
bool one_wave(K* kernel, int bytes, int threads, int splits,
              long long clusters) {
  struct Seen {
    int bytes, threads, splits, fit;
  };
  static thread_local Seen seen[32];
  static thread_local int used = 0;
  for (int i = 0; i < used; ++i)
    if (seen[i].bytes == bytes && seen[i].threads == threads &&
        seen[i].splits == splits)
      return clusters <= seen[i].fit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a shape that cannot run: not one wave
    fit = 0;
  }
  seen[used % 32] = {bytes, threads, splits, fit};
  used = used < 32 ? used + 1 : 32;
  return clusters <= fit;
}

template <typename T, int DP>
int launch_decode(const Args& a) {
  // blocks of up to 220 KB where every cluster of the grid then runs at
  // once, else of at most 112 KB (two blocks share an SM), else the
  // smallest plan, in several waves (f32 at D 256: one warp's ring alone
  // passes 112 KB)
  constexpr int kMaxBytes = 220 * 1024, kTwoPerSm = 112 * 1024;
  constexpr int ve = vec_elems<T>();
  auto* kernel = flash_decode_kernel<T, DP>;
  static bool opted_in = false;  // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int group = a.Hq / a.Hkv;
  DecLayout lay;
  const int round = std::is_same_v<T, float> ? 4 : 16;  // bf16: mma's K
  lay.dp = (a.D + round - 1) / round * round;
  // bulk copies need 16-byte rows: D fills whole 16 bytes and every
  // K/V base and stride is a multiple of 16 bytes
  const bool vec = a.D % ve == 0 && rows16(a.k, a.ks, ve) &&
                   rows16(a.v, a.vs, ve);
  const int units = lay.dp / ve;
  lay.kst = (units % 2 ? units : units + 1) * ve;
  const int R = group * a.Tq;
  lay.rows = R < dec_rows<T, DP>() ? R : dec_rows<T, DP>();
  const int chunks = (R + lay.rows - 1) / lay.rows;
  if (static_cast<long long>(a.Hkv) * chunks > 65535)
    return cudaErrorInvalidValue;
  const long long clusters = static_cast<long long>(a.Hkv) * chunks * a.B;
  // (warps, stages): the most warps, then the deepest ring, whose grid
  // runs in one wave; else the first of at most 112 KB; else the last
  // (fewest bytes) of at most 220 KB
  constexpr int kPlans[][2] = {{8, 3}, {8, 2}, {6, 2}, {4, 3},
                               {4, 2}, {3, 2}, {2, 2}, {1, 2}};
  DecLayout fallback{}, smallest{};
  bool found = false;
  for (const auto& p : kPlans) {
    lay.nw = p[0];
    lay.ns = p[1];
    const int rings = lay.nw * dec_warp_bytes<T>(lay);
    const int merge = dec_merge_bytes(lay);
    lay.bytes = dec_fixed_bytes(lay) + (rings > merge ? rings : merge);
    if (lay.bytes > kMaxBytes) continue;
    smallest = lay;
    if (fallback.bytes == 0 && lay.bytes <= kTwoPerSm) fallback = lay;
    if (one_wave(kernel, lay.bytes, lay.nw * 32, a.splits, clusters)) {
      found = true;
      break;
    }
  }
  if (!found) {
    if (fallback.bytes == 0) fallback = smallest;
    if (fallback.bytes == 0) return cudaErrorInvalidValue;
    lay = fallback;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.splits),
                     static_cast<unsigned>(a.Hkv * chunks),
                     static_cast<unsigned>(a.B));
  cfg.blockDim = dim3(static_cast<unsigned>(lay.nw * 32));
  cfg.dynamicSmemBytes = static_cast<size_t>(lay.bytes);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;  // one split: no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<const long long*>(a.kv_len), a.Hq, group, a.Tq, a.Tk, a.D,
      a.qs, a.ks, a.vs, a.scale, a.softcap, a.causal, a.window, lay,
      vec ? 1 : 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a) {
  if (a.B < 1 || a.B > 65535 || a.Hq < 1 || a.Hq > 65535 || a.Hkv < 1 ||
      a.Hq % a.Hkv || a.Tq < 1 || a.Tk < 1 || a.D < 1 || a.D > 256 ||
      a.splits < 1 || a.splits > kDecMaxSplits)
    return cudaErrorInvalidValue;
  if (a.Tq <= kDecodeTq) {  // decode: keys split across a cluster
    if (a.D <= 64) return launch_decode<T, 64>(a);
    if (a.D <= 128) return launch_decode<T, 128>(a);
    if (a.D <= 160) return launch_decode<T, 160>(a);
    return launch_decode<T, 256>(a);
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // wgmma
    if (a.D <= 64) return launch_tc<64>(a);
    if (a.D <= 128) return launch_tc<128>(a);
    if (a.D <= 160) return launch_tc<160>(a);
    return launch_tc<256>(a);
  } else {  // 3xTF32 mma.sync
    if (a.D <= 64) return launch_tf32<64>(a);
    if (a.D <= 128) return launch_tf32<128>(a);
    if (a.D <= 160) return launch_tf32<160>(a);
    return launch_tf32<256>(a);
  }
}

}  // namespace

// (q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, q strides (b, h, t),
// k strides, v strides, scale, softcap, causal, window, splits, stream):
// q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) at the given element strides with
// a contiguous last dim; out a new contiguous (B, Tq, Hq, D) array of
// q's dtype; kv_len null or B int64 counts on the device. Hq % Hkv == 0,
// D <= 256; splits (1 to 16) the blocks, one cluster, that share a key
// head's keys at decode (Tq <= 4; ignored otherwise). Returns the
// cudaError_t of the launch.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      void* out, const void* kv_len, int B, int Hq, int Hkv, \
                      int Tq, int Tk, int D, long long qsb, long long qsh,   \
                      long long qst, long long ksb, long long ksh,           \
                      long long kst, long long vsb, long long vsh,           \
                      long long vst, float scale, float softcap, int causal, \
                      int window, int splits, void* stream) {                \
    const Args a{q,       k,      v,      out,    kv_len,                    \
                 B,       Hq,     Hkv,    Tq,     Tk,                        \
                 D,       {qsb, qsh, qst},        {ksb, ksh, kst},           \
                 {vsb, vsh, vst}, scale,  softcap, causal, window,           \
                 splits,  static_cast<cudaStream_t>(stream)};                \
    return dispatch<T>(a);                                                   \
  }
FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
