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
// here one block per query block (of one head, or for the tensor-core
// kernel of a key head's group of query heads) and batch row walks the
// kv tiles itself, and only those the causal bound, the window and kv_len leave
// visible: the state (m, l and each row's share of acc) stays in f32
// registers for the whole walk. Query heads map to key heads by
// h / group, so grouped heads read the same K/V rows (from L2) and no
// copy of the cache is made.
//
// Bound: the larger of bytes and operations. Bytes: q, k, v read once and
// out written once. Operations: 4 * B * Hq * Tq * Tk_visible * D (two
// products a visible score), on the bf16 tensor cores for bf16 inputs
// (989 TFLOP/s), the f32 units for f32 (67 TFLOP/s). At the served
// decode shapes (Tq 1) the bytes bound it (the cache is read once, every
// score's product is 2 flops a byte); at a long prefill the operations
// do (gemma2-27b's 4,352 tokens: 156.4 us at the tensor-core rate).
// Three kernels, chosen by the host on shape and dtype:
// - bf16 with Tq > kRows (prefill): flash_tc_kernel, the products on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), K/V
//   tiles staged by cp.async two deep, a GQA group's query heads packed
//   into one block so that a K/V tile serves all of them (see the
//   kernel's note below);
// - f32 with Tq > kRows: flash_kernel, on the f32 units: the f32 check
//   (1e-5 of a row's largest |value|) is beyond what bf16 or TF32
//   rounding of f32 inputs keeps. A warp's 32 lanes take one key each
//   for the scores (rows of the K tile padded by one float, so the
//   lanes' reads fall in distinct banks) and split D among them for the
//   weighted sum of V; each warp keeps kRows query rows, so a K/V tile
//   staged in shared memory serves kRows * 4 rows;
// - Tq <= kRows (decode), either dtype: flash_split_kernel: the block
//   stages kSplitWarps tiles at a time, each warp takes one of them for
//   all Tq rows, and the warps' (m, l, acc) are merged at the end.
// expf and tanhf without fast-math; the mask zeroes each weight after
// the exp (two hidden scores would give exp(0) = 1 otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;           // warps a block
constexpr int kRows = 4;            // query rows a warp
constexpr int kBQ = kWarps * kRows; // query rows a block
constexpr int kBK = 32;             // keys a tile: one a lane
constexpr int kSplitWarps = 8;      // warps a block, keys split (decode)
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

template <int DMAX>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * DMAX + kBK * (DMAX + 1) + kBK * DMAX);
}

// DMAX: compile-time bound on D (64, 128 or 256), so each lane's share of
// a row's accumulator (DMAX / 32 values) is an array of registers.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const long long* __restrict__ kv_len, int Hq, int group,
             int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
             float scale, float softcap, int causal, int window) {
  constexpr int kDL = DMAX / 32;       // accumulator values a lane
  constexpr int kKS = DMAX + 1;        // K tile row stride (padded)
  extern __shared__ float smem[];
  float* sq = smem;                    // [kBQ][DMAX]
  float* sk = sq + kBQ * DMAX;         // [kBK][kKS]
  float* sv = sk + kBK * kKS;          // [kBK][DMAX]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long n = Tk;
  if (kv_len != nullptr)
    n = lmin(lmax(kv_len[b], 0), Tk);
  const long long off = n - Tq;        // query i sits at position off + i

  const T* qb = q + b * qs.b + h * qs.h;
  for (int e = tid; e < kBQ * DMAX; e += kWarps * 32) {
    const int r = e / DMAX, d = e % DMAX;
    sq[e] = (q0 + r < Tq && d < D) ? to_f(qb[(q0 + r) * qs.t + d]) : 0.0f;
  }

  // the keys this block's rows can see: [kbeg, kend)
  const long long qlo = off + q0;
  const long long qhi = off + min(q0 + kBQ, Tq) - 1;
  long long kbeg = 0, kend = n;
  if (causal) kend = lmin(kend, qhi + 1);
  if (window > 0) kbeg = lmax(kbeg, qlo - window + 1);

  float m[kRows], l[kRows], acc[kRows][kDL];
  long long pos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    pos[i] = off + q0 + warp * kRows + i;
#pragma unroll
    for (int c = 0; c < kDL; ++c) acc[i][c] = 0.0f;
  }

  // a warp whose rows all lie past Tq (the ragged last block, decode)
  // only helps stage the tiles
  const bool busy = q0 + warp * kRows < Tq;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const float* myq = sq + warp * kRows * DMAX;
  for (long long k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kBK * D; e += kWarps * 32) {
      const int j = e / D, d = e % D;
      const long long kp = k0 + j;
      const bool in = kp < kend;
      sk[j * kKS + d] = in ? to_f(kb[kp * ks.t + d]) : 0.0f;
      sv[j * DMAX + d] = in ? to_f(vb[kp * vs.t + d]) : 0.0f;
    }
    __syncthreads();
    if (!busy) continue;

    // scores: lane j takes key k0 + j for each of the warp's rows
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.0f;
    const float* kr = sk + lane * kKS;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = fmaf(myq[i * DMAX + d], kd, s[i]);
    }
    const long long kp = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float x = s[i] * scale;
      if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
      bool vis = kp < kend;
      if (causal) vis = vis && kp <= pos[i];
      if (window > 0) vis = vis && kp > pos[i] - window;
      x = vis ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      p[i] = vis ? expf(x - m_new) : 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDL; ++c) acc[i][c] *= alpha;
    }

    // weighted sum of V: lane owns dims lane, lane + 32, ...
    const int nk = static_cast<int>(lmin(kBK, kend - k0));
    for (int j = 0; j < nk; ++j) {
      float vj[kDL];
#pragma unroll
      for (int c = 0; c < kDL; ++c)
        vj[c] = lane + 32 * c < D ? sv[j * DMAX + lane + 32 * c] : 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < kDL; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + warp * kRows + i;
    if (t >= Tq) continue;
    T* o = out + ((static_cast<long long>(b) * Tq + t) * Hq + h) * D;
    const float inv = l[i] + 1e-30f;
#pragma unroll
    for (int c = 0; c < kDL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = from_f<T>(acc[i][c] / inv);
    }
  }
}

// Tq <= kRows (decode): one block of nw <= kSplitWarps warps per (head,
// batch row). The block stages a chunk of nw * kBK visible keys at a
// time in shared memory, in the input dtype, with 16-byte cp.async
// copies where the rows allow them (so a whole chunk is in flight at
// once); warp w takes the chunk's w-th tile of kBK keys for all Tq rows:
// lane j scores key j against q (K rows padded to an odd number of 16
// bytes, so a quarter-warp's 16-byte reads fall in distinct banks), and
// lanes split D for the weighted sum of V. The warps' (m, l, acc) are
// merged through shared memory at the end (over the staging area).
template <typename T>
__host__ __device__ constexpr int vec_elems() {  // elements in 16 B
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// 16 bytes of T at p (16-byte aligned) as floats
__device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// shared memory of the decode kernel: q rows (f32), then the K and V
// chunk (T), over which the merge area (f32) is laid at the end
struct SplitLayout {
  int dp;   // D rounded up to 16 bytes of T
  int kst;  // K row stride (elements): an odd number of 16 bytes
  int nw;   // warps
  int bytes;
};

template <typename T, int DMAX>
SplitLayout split_layout(int D, int max_bytes) {
  constexpr int ve = vec_elems<T>();
  SplitLayout L;
  L.dp = (D + ve - 1) / ve * ve;
  const int units = L.dp / ve;
  L.kst = (units % 2 ? units : units + 1) * ve;
  for (L.nw = kSplitWarps; ; L.nw /= 2) {
    const int stage = L.nw * kBK * (L.kst + L.dp) *
                      static_cast<int>(sizeof(T));
    const int merge = static_cast<int>(sizeof(float)) * L.nw * kRows *
                      (DMAX + 2);
    L.bytes = static_cast<int>(sizeof(float)) * kRows * L.dp +
              (stage > merge ? stage : merge);
    if (L.bytes <= max_bytes || L.nw == 1) break;
  }
  return L;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kSplitWarps * 32)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const long long* __restrict__ kv_len, int Hq, int group,
                   int Tq, int Tk, int D, Strides qs, Strides ks, Strides vs,
                   float scale, float softcap, int causal, int window,
                   SplitLayout lay, int vec) {
  constexpr int kDL = DMAX / 32;
  constexpr int kVE = vec_elems<T>();
  const int dp = lay.dp, kst = lay.kst, nw = lay.nw;
  const int chunk = nw * kBK;
  extern __shared__ __align__(16) unsigned char raw[];
  float* sq = reinterpret_cast<float*>(raw);          // [kRows][dp]
  T* sk = reinterpret_cast<T*>(sq + kRows * dp);      // [chunk][kst]
  T* sv = sk + chunk * kst;                           // [chunk][dp]
  float* sacc = sq + kRows * dp;                      // [nw][kRows][DMAX]
  float* sm = sacc + nw * kRows * DMAX;               // [nw][kRows]
  float* sl = sm + nw * kRows;                        // [nw][kRows]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = nw * 32;
  long long n = Tk;
  if (kv_len != nullptr)
    n = lmin(lmax(kv_len[b], 0), Tk);
  const long long off = n - Tq;
  long long kbeg = 0, kend = n;
  if (causal) kend = lmin(kend, off + Tq);
  if (window > 0) kbeg = lmax(kbeg, off - window + 1);

  const T* qb = q + b * qs.b + h * qs.h;
  for (int e = tid; e < kRows * dp; e += nthr) {
    const int i = e / dp, d = e % dp;
    sq[e] = (i < Tq && d < D) ? to_f(qb[i * qs.t + d]) : 0.0f;
  }
  float m[kRows], l[kRows], acc[kRows][kDL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDL; ++c) acc[i][c] = 0.0f;
  }

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (long long c0 = kbeg; c0 < kend; c0 += chunk) {
    const int rows = static_cast<int>(lmin(chunk, kend - c0));
    __syncthreads();  // q is staged; the previous chunk has been consumed
    if (vec) {
      const int per_row = dp / kVE;
      for (int e = tid; e < rows * per_row; e += nthr) {
        const int j = e / per_row, d = (e % per_row) * kVE;
        cp_async16(sk + j * kst + d, kb + (c0 + j) * ks.t + d);
        cp_async16(sv + j * dp + d, vb + (c0 + j) * vs.t + d);
      }
      cp_async_wait_all();
    } else {
      for (int e = tid; e < rows * dp; e += nthr) {
        const int j = e / dp, d = e % dp;
        const bool in = d < D;
        sk[j * kst + d] = in ? kb[(c0 + j) * ks.t + d] : from_f<T>(0.0f);
        sv[j * dp + d] = in ? vb[(c0 + j) * vs.t + d] : from_f<T>(0.0f);
      }
    }
    __syncthreads();

    const int j0 = warp * kBK;  // this warp's tile: chunk rows [j0, j0 + nk)
    const int nk = rows - j0 < kBK ? rows - j0 : kBK;
    if (nk <= 0) continue;
    // scores: lane j takes key c0 + j0 + j for each row
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.0f;
    if (lane < nk) {
      const T* kr = sk + (j0 + lane) * kst;
      for (int d = 0; d < dp; d += kVE) {
        float kd[kVE];
        unpack16(kr + d, kd);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i >= Tq) break;
          float qd[4];
#pragma unroll
          for (int e = 0; e < kVE; e += 4) {
            unpack16(sq + i * dp + d + e, qd);
#pragma unroll
            for (int u = 0; u < 4; ++u) s[i] = fmaf(qd[u], kd[e + u], s[i]);
          }
        }
      }
    }
    const long long kp = c0 + j0 + lane;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      p[i] = 0.0f;
      if (i >= Tq) break;
      const long long pos = off + i;
      float x = s[i] * scale;
      if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
      bool vis = lane < nk;
      if (causal) vis = vis && kp <= pos;
      if (window > 0) vis = vis && kp > pos - window;
      x = vis ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      p[i] = vis ? expf(x - m_new) : 0.0f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDL; ++c) acc[i][c] *= alpha;
    }
    // weighted sum of V: lane owns dims lane, lane + 32, ...
    for (int j = 0; j < nk; ++j) {
      const T* vr = sv + (j0 + j) * dp;
      float vj[kDL];
#pragma unroll
      for (int c = 0; c < kDL; ++c)
        vj[c] = lane + 32 * c < D ? to_f(vr[lane + 32 * c]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i >= Tq) break;
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < kDL; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
    }
  }

  // merge: out = sum_w e^(m_w - M) acc_w / (sum_w e^(m_w - M) l_w + 1e-30)
  // with M the largest m_w; a warp that saw no key holds m = kNegInf,
  // l = 0, acc = 0 and adds nothing (or, if no warp saw one, 0 / 1e-30)
  __syncthreads();  // the staging area becomes the merge area
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i >= Tq) break;
    if (lane == 0) {
      sm[warp * kRows + i] = m[i];
      sl[warp * kRows + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kDL; ++c)
      sacc[(warp * kRows + i) * DMAX + lane + 32 * c] = acc[i][c];
  }
  __syncthreads();
  for (int e = tid; e < Tq * D; e += nthr) {
    const int i = e / D, d = e % D;
    float M = kNegInf;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, sm[w * kRows + i]);
    float L = 0.0f, a = 0.0f;
    for (int w = 0; w < nw; ++w) {
      const float f = expf(sm[w * kRows + i] - M);
      L = fmaf(f, sl[w * kRows + i], L);
      a = fmaf(f, sacc[(w * kRows + i) * DMAX + d], a);
    }
    out[((static_cast<long long>(b) * Tq + i) * Hq + h) * D + d] =
        from_f<T>(a / (L + 1e-30f));
  }
}

// Tq > kRows in bf16 (prefill): the tensor-core kernel. A block of one
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

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              const void* kv_len, int B, int Hq, int Hkv, int Tq, int Tk,
              int D, Strides qs, Strides ks, Strides vs, float scale,
              float softcap, int causal, int window, cudaStream_t stream) {
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
      (static_cast<long long>(Hq / Hkv) * Tq + kTcRows - 1) / kTcRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  // 16-byte copies need D whole 16 bytes and every row 16-byte aligned
  const auto al = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = D % 8 == 0 && al(q) && al(k) && al(v) && qs.b % 8 == 0 &&
                   qs.h % 8 == 0 && qs.t % 8 == 0 && ks.b % 8 == 0 &&
                   ks.h % 8 == 0 && ks.t % 8 == 0 && vs.b % 8 == 0 &&
                   vs.h % 8 == 0 && vs.t % 8 == 0;
  kernel<<<dim3(Hkv, B, static_cast<unsigned>(tiles)), kTcThreads, bytes,
           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const long long*>(kv_len), Hq, Hq / Hkv, Tq, Tk, D, qs, ks,
      vs, scale, softcap, causal, window, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* kv_len, int B, int Hq, int Hkv, int Tq, int Tk, int D,
           Strides qs, Strides ks, Strides vs, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  if (Tq <= kRows) {
    constexpr int kMaxSplitBytes = 200 * 1024;
    const SplitLayout lay = split_layout<T, DMAX>(D, kMaxSplitBytes);
    auto* split = flash_split_kernel<T, DMAX>;
    static bool split_opted_in = false;  // once per instantiation
    if (!split_opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          split, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSplitBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      split_opted_in = true;
    }
    // 16-byte copies need 16-byte rows: D fills whole 16 bytes and every
    // K/V base and stride is a multiple of 16 bytes
    constexpr long long kE = 16 / static_cast<long long>(sizeof(T));
    const bool vec = D % kE == 0 &&
                     reinterpret_cast<unsigned long long>(k) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(v) % 16 == 0 &&
                     ks.b % kE == 0 && ks.h % kE == 0 && ks.t % kE == 0 &&
                     vs.b % kE == 0 && vs.h % kE == 0 && vs.t % kE == 0;
    split<<<dim3(1, Hq, B), lay.nw * 32, lay.bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<const long long*>(kv_len), Hq, Hq / Hkv, Tq, Tk, D, qs,
        ks, vs, scale, softcap, causal, window, lay, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (!std::is_same_v<T, float>) {
    return cudaErrorInvalidValue;  // bf16 prefill runs flash_tc_kernel
  } else {
    constexpr int bytes = smem_bytes<DMAX>();
    auto* kernel = flash_kernel<T, DMAX>;
    static bool opted_in = false;  // above 48 KB, once per instantiation
    if (bytes > 48 * 1024 && !opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in = true;
    }
    const dim3 grid((Tq + kBQ - 1) / kBQ, Hq, B);
    kernel<<<grid, kWarps * 32, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<const long long*>(kv_len), Hq, Hq / Hkv, Tq, Tk, D, qs,
        ks, vs, scale, softcap, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const void* kv_len, int B, int Hq, int Hkv, int Tq, int Tk,
             int D, long long qsb, long long qsh, long long qst,
             long long ksb, long long ksh, long long kst, long long vsb,
             long long vsh, long long vst, float scale, float softcap,
             int causal, int window, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || Hq % Hkv ||
      Tq < 1 || Tk < 1 || D < 1 || D > 256)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (Tq > kRows) {  // bf16 prefill: the tensor cores
      if (D <= 64)
        return launch_tc<64>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qs,
                             ks, vs, scale, softcap, causal, window, s);
      if (D <= 128)
        return launch_tc<128>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D,
                              qs, ks, vs, scale, softcap, causal, window, s);
      if (D <= 160)
        return launch_tc<160>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D,
                              qs, ks, vs, scale, softcap, causal, window, s);
      return launch_tc<256>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qs,
                            ks, vs, scale, softcap, causal, window, s);
    }
  }
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qs, ks,
                         vs, scale, softcap, causal, window, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qs,
                          ks, vs, scale, softcap, causal, window, s);
  return launch<T, 256>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qs, ks,
                        vs, scale, softcap, causal, window, s);
}

}  // namespace

// (q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, q strides (b, h, t),
// k strides, v strides, scale, softcap, causal, window, stream): q
// (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) at the given element strides with
// a contiguous last dim; out a new contiguous (B, Tq, Hq, D) array of
// q's dtype; kv_len null or B int64 counts on the device. Hq % Hkv == 0,
// D <= 256. Returns the cudaError_t of the launch.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      void* out, const void* kv_len, int B, int Hq, int Hkv, \
                      int Tq, int Tk, int D, long long qsb, long long qsh,   \
                      long long qst, long long ksb, long long ksh,           \
                      long long kst, long long vsb, long long vsh,           \
                      long long vst, float scale, float softcap, int causal, \
                      int window, void* stream) {                            \
    return dispatch<T>(q, k, v, out, kv_len, B, Hq, Hkv, Tq, Tk, D, qsb,     \
                       qsh, qst, ksb, ksh, kst, vsb, vsh, vst, scale,        \
                       softcap, causal, window, stream);                     \
  }
FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
