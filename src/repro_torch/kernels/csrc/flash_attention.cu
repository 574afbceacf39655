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
// here one block per (q-block, head, batch row) walks the kv tiles
// itself, and only those the causal bound, the window and kv_len leave
// visible: the state (m, l and each row's share of acc) stays in f32
// registers for the whole walk. Query heads map to key heads by
// h / group, so grouped heads read the same K/V rows (from L2) and no
// copy of the cache is made.
//
// Bound: the larger of bytes and operations. Bytes: q, k, v read once and
// out written once. Operations: 4 * B * Hq * Tq * Tk_visible * D (two
// products a visible score). At the served decode shapes (Tq 1) the
// bytes bound it (the cache is read once, every score's product is
// 2 flops a byte); at a long prefill the operations do. This first
// version computes on the f32 units, not the tensor cores: a warp's 32
// lanes take one key each for the scores (rows of the K tile padded by
// one float, so the lanes' reads fall in distinct banks) and split D
// among them for the weighted sum of V; each warp keeps kRows query
// rows, so a K/V tile staged in shared memory serves kRows * 4 rows.
// A block of Tq <= kRows rows (decode) would leave all warps but one
// idle there, so it runs another kernel (flash_split_kernel): the block
// stages kSplitWarps tiles at a time, each warp takes one of them for
// all Tq rows, and the warps' (m, l, acc) are merged at the end.
// expf and tanhf without fast-math; the mask zeroes each weight after
// the exp (two hidden scores would give exp(0) = 1 otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
      static_cast<const long long*>(kv_len), Hq, Hq / Hkv, Tq, Tk, D, qs, ks,
      vs, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
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
