// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), in f32:
//   o_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//   S[k, v] <- exp(logw_t[k]) * S[k, v] + k_t[k] * v_t[v]
// over r, k, logw (B, H, T, K), v (B, H, T, V), u (H, K) and the initial
// state s0 (B, H, K, V); writes out (B, H, T, V) and the final state
// s_fin (B, H, K, V).
//
// Replaces the Pallas TPU kernel `wkv` in src/repro/kernels/wkv.py
// (pallas_call at line 91). That kernel runs a sequential grid over chunks
// of C tokens per (b, h), keeps the (K, V) state in VMEM scratch across
// the chunks and evaluates each chunk in the parallel form, with a
// (C, C, K) tile of pair decays exp(L_t - L_s). Here the token loop runs
// inside the block and the state stays in registers for the whole
// sequence, evaluated token by token; no pair tile is formed. The chunked
// and the sequential forms compute the same function; their float
// rounding differs, and the plain version (repro_torch/kernels/ref.py,
// `wkv_ref`) sums over k in another order, so the two agree to a stated
// tolerance, not bit for bit.
//
// Bound: memory. The function reads r, k, logw, v once, u once and s0
// once and writes out and s_fin once: 4 * (B*H*T*(3K + 2V) + H*K + 2*B*H*K*V)
// bytes, about 9.4 MB at the rwkv6-1.6b prefill shape (B 4, H 32, T 32,
// K = V = 64; 2.8 us at 3.35 TB/s) and 4.4 MB at decode (T 1, the state
// read and written; 1.3 us). Its arithmetic, 7 flops per (token, k, v),
// is 117 MFLOP at the prefill shape (1.7 us at 67 TFLOP/s f32).
//
// Design. Column v of the state evolves alone, so a (b, h)'s V columns are
// split over warps (and, where B*H blocks would leave SMs idle, over
// blocks) and its K rows over LANES lanes of a warp: a thread holds a
// 4 x 4 tile of the state (4 rows, 4 neighbouring columns) in registers,
// read from s0 and written to s_fin as 16-byte vectors (at LANES 16 a
// warp instruction moves the warp's 8 columns, 32 contiguous bytes, of 16
// rows). Per token a thread forms its rows' share of o_t for its 4
// columns (the bonus folded in as v_t[j] * sum_k r_t[k] u[k] k_t[k]). The
// LANES partial sums are combined for kGroup = 8 tokens at once, 32
// (token, column) values, by a butterfly of __shfl_xor_sync in a fixed
// order that leaves 32 / LANES whole sums on each lane (30 shuffles for 8
// tokens at LANES 16), so no token waits on its own shuffles before the
// next computes; a tile's last tokens go 4 at once, then one at a time
// (decode's one token). The block stages kTile tokens of r, k, logw and
// its columns of v in shared memory with 16-byte cp.async copies (4-byte
// ones where K, V or a base is not 16-byte aligned), two tiles in flight:
// the next tile lands while this one computes, and the first tiles are
// issued before the state is read. exp(logw) is taken once per element,
// in place, when a tile has landed. The grid is B*H*splits blocks of
// `warps` warps, both from the host (ops.wkv_layout): 128 blocks of 8
// warps at the serve shape.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;      // tokens a stage holds
constexpr int kWidth = 64;     // largest K and V
constexpr int kMaxWarps = 8;   // warps a block at most
constexpr int kGroup = 8;      // tokens whose sums are combined at once

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Sums v over the lanes that differ in the bits of M, M / 2, ..., 1, in a
// fixed order. While more than one value is left, a step splits them: a
// lane keeps the half its bit of the mask selects and adds its partner's
// copy of that half. Then the remaining masks add up the one value (the
// same sum on every lane that shares it). On return v[i], for i <
// max(1, NV / (2M)), holds the sum over the lanes of their values at
// index first + i.
template <int M, int NV, int N = NV>
__device__ __forceinline__ void butterfly(float (&v)[NV], int lane,
                                          int& first) {
  if constexpr (M >= 1) {
    if constexpr (N > 1) {
      constexpr int kHalf = N / 2;
      const bool hi = lane & M;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = hi ? v[i] : v[i + kHalf];
        const float keep = hi ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      first += hi ? kHalf : 0;
      butterfly<M / 2, NV, kHalf>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      butterfly<M / 2, NV, 1>(v, lane, first);
    }
  }
}

// One tile of kTile tokens: the rows of r, k and logw (exp(logw) once the
// tile has landed), and the block's columns of v. Rows are padded to
// 4 * LANES values; the padding is zero, so it adds nothing.
template <int LANES>
struct __align__(16) Stage {
  float r[kTile][4 * LANES];
  float k[kTile][4 * LANES];
  float w[kTile][4 * LANES];
  float v[kTile][kWidth];
};

// Issue the copies of tokens [t0, t0 + nt) into `st`.
template <int LANES, bool VEC>
__device__ __forceinline__ void stage_tile(
    Stage<LANES>& st, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ lw, const float* __restrict__ v,
    long long base_k, long long base_v, int t0, int nt, int K, int V, int c0,
    int nc) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (VEC) {
    const int kq = K / 4, vq = nc / 4;
    for (int e = tid; e < nt * kq; e += nthreads) {
      const int tt = e / kq, q = e - tt * kq;
      const long long g = base_k + static_cast<long long>(t0 + tt) * K + 4 * q;
      cp16(&st.r[tt][4 * q], r + g);
      cp16(&st.k[tt][4 * q], k + g);
      cp16(&st.w[tt][4 * q], lw + g);
    }
    for (int e = tid; e < nt * vq; e += nthreads) {
      const int tt = e / vq, q = e - tt * vq;
      cp16(&st.v[tt][4 * q],
           v + base_v + static_cast<long long>(t0 + tt) * V + c0 + 4 * q);
    }
  } else {
    for (int e = tid; e < nt * K; e += nthreads) {
      const int tt = e / K, i = e - tt * K;
      const long long g = base_k + static_cast<long long>(t0 + tt) * K + i;
      cp4(&st.r[tt][i], r + g);
      cp4(&st.k[tt][i], k + g);
      cp4(&st.w[tt][i], lw + g);
    }
    for (int e = tid; e < nt * nc; e += nthreads) {
      const int tt = e / nc, i = e - tt * nc;
      cp4(&st.v[tt][i],
          v + base_v + static_cast<long long>(t0 + tt) * V + c0 + i);
    }
  }
}

// G tokens from tile row g on: this thread's rows of o for its 4 columns
// (the bonus folded in as v_t[j] * sum_k r_t[k] u[k] k_t[k]) and the state
// update, then the sum of o over the LANES lanes of the columns, for all
// G tokens at once (4G (token, column) values: max(1, 4G / LANES) sums a
// lane; past that the lanes that share a sum write it once). o points at
// the thread's first column of token g; `live` columns of it exist.
template <int G, int LANES>
__device__ __forceinline__ void tokens(const Stage<LANES>& S, int g, int row,
                                       int lc, int kl, const float (&uu)[4],
                                       float (&s)[4][4], float* o, int live,
                                       int V) {
  float a[4 * G];  // a[4q + j]: token g + q, column j
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int tt = g + q;
    const float4 r4 = *reinterpret_cast<const float4*>(&S.r[tt][row]);
    const float4 k4 = *reinterpret_cast<const float4*>(&S.k[tt][row]);
    const float4 w4 = *reinterpret_cast<const float4*>(&S.w[tt][row]);
    const float4 v4 = *reinterpret_cast<const float4*>(&S.v[tt][lc]);
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    float p = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) p = fmaf(rr[i], uu[i] * kk[i], p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = vv[j] * p;
#pragma unroll
      for (int i = 0; i < 4; ++i) x = fmaf(rr[i], s[i][j], x);
      a[4 * q + j] = x;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = fmaf(ww[i], s[i][j], kk[i] * vv[j]);
  }
  int first = 0;
  butterfly<LANES / 2, 4 * G>(a, kl, first);
  constexpr int kSums = LANES < 4 * G ? 4 * G / LANES : 1;
  constexpr int kShared = LANES > 4 * G ? LANES / (4 * G) - 1 : 0;
  if ((kl & kShared) != 0) return;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const int q = (first + i) / 4, j = (first + i) % 4;
    if (j < live) o[static_cast<long long>(q) * V + j] = a[i];
  }
}

// LANES: lanes over K (4, 8 or 16; 4 * LANES >= K). VEC: K and V multiples
// of 4 and every base 16-byte aligned, so rows move as 16-byte vectors.
template <int LANES, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ out, float* __restrict__ s_fin, int H, int T,
           int K, int V, int splits) {
  constexpr int kCols = 4 * (32 / LANES);  // columns a warp
  constexpr int kRows = 4 * LANES;         // rows a warp (padded K)
  __shared__ Stage<LANES> st[2];
  const int warps = blockDim.x / 32;
  const long long bh = blockIdx.x / splits;
  const int h = static_cast<int>(bh % H);
  const int tid = threadIdx.x, lane = tid & 31;
  const int kl = lane % LANES;
  const int lc = (tid >> 5) * kCols + (lane / LANES) * 4;  // in the block
  const int c0 = static_cast<int>(blockIdx.x % splits) * warps * kCols;
  const int nc = min(V - c0, warps * kCols);
  const int col = c0 + lc;  // the thread's first column
  const int row = 4 * kl;   // and first row
  const long long base_k = bh * T * K, base_v = bh * T * V;
  const int ntiles = (T + kTile - 1) / kTile;

  // zero the row padding of both stages (never a copy's destination)
  for (int e = tid; e < 2 * kTile * (kRows - K); e += blockDim.x) {
    const int s = e / (kTile * (kRows - K));
    const int rest = e - s * kTile * (kRows - K);
    const int tt = rest / (kRows - K), i = K + rest % (kRows - K);
    st[s].r[tt][i] = 0.0f;
    st[s].k[tt][i] = 0.0f;
    st[s].w[tt][i] = 0.0f;
  }
  stage_tile<LANES, VEC>(st[0], r, k, logw, v, base_k, base_v, 0,
                         min(kTile, T), K, V, c0, nc);
  commit();
  if (ntiles > 1)
    stage_tile<LANES, VEC>(st[1], r, k, logw, v, base_k, base_v, kTile,
                           min(kTile, T - kTile), K, V, c0, nc);
  commit();

  // the state tile and u, while the copies fly
  float s[4][4], uu[4];
  const float* s_in = s0 + bh * K * V;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool on = row + i < K;
    uu[i] = on ? u[h * K + row + i] : 0.0f;
    const float* src = s_in + static_cast<long long>(row + i) * V + col;
    if (VEC) {
      const float4 x = (on && col < V) ? *reinterpret_cast<const float4*>(src)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      s[i][0] = x.x, s[i][1] = x.y, s[i][2] = x.z, s[i][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = (on && col + j < V) ? src[j] : 0.f;
    }
  }

  for (int ti = 0; ti < ntiles; ++ti) {
    Stage<LANES>& S = st[ti & 1];
    const int t0 = ti * kTile, nt = min(kTile, T - t0);
    wait_all_but_newest();  // tile ti has landed (this thread's copies)
    __syncthreads();        // (everyone's)
    for (int e = tid; e < nt * K; e += blockDim.x) {
      const int tt = e / K, i = e - tt * K;
      S.w[tt][i] = expf(S.w[tt][i]);
    }
    __syncthreads();
    int g = 0;
    float* o = out + base_v + static_cast<long long>(t0) * V + col;
    for (; g + kGroup <= nt; g += kGroup)
      tokens<kGroup, LANES>(S, g, row, lc, kl, uu, s, o + g * V, V - col, V);
    if (g + kGroup / 2 <= nt) {  // the tile's last tokens: 4, then singly
      tokens<kGroup / 2, LANES>(S, g, row, lc, kl, uu, s, o + g * V, V - col,
                                V);
      g += kGroup / 2;
    }
    for (; g < nt; ++g)
      tokens<1, LANES>(S, g, row, lc, kl, uu, s, o + g * V, V - col, V);
    __syncthreads();  // the stage is consumed
    if (ti + 2 < ntiles)
      stage_tile<LANES, VEC>(S, r, k, logw, v, base_k, base_v, t0 + 2 * kTile,
                             min(kTile, T - t0 - 2 * kTile), K, V, c0, nc);
    commit();
  }

  float* s_out = s_fin + bh * K * V;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row + i >= K) continue;
    float* dst = s_out + static_cast<long long>(row + i) * V + col;
    if (VEC) {
      if (col < V)
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < V) dst[j] = s[i][j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int LANES>
void launch(bool vec, unsigned blocks, int warps, const float* r,
            const float* k, const float* v, const float* lw, const float* u,
            const float* s0, float* out, float* s_fin, int H, int T, int K,
            int V, int splits, cudaStream_t stream) {
  if (vec)
    wkv_kernel<LANES, true><<<blocks, warps * 32, 0, stream>>>(
        r, k, v, lw, u, s0, out, s_fin, H, T, K, V, splits);
  else
    wkv_kernel<LANES, false><<<blocks, warps * 32, 0, stream>>>(
        r, k, v, lw, u, s0, out, s_fin, H, T, K, V, splits);
}

}  // namespace

// (r, k, v, logw, u, s0, out, s_fin, B, H, T, K, V, lanes, warps, stream);
// every array f32 and contiguous in the layout above, out and s_fin not
// aliasing any input. lanes (4, 8 or 16, with 4 * lanes >= K) split the K
// rows, and each of a (b, h)'s ceil(V / (warps * 128 / lanes)) blocks
// holds `warps` warps of 128 / lanes columns each (ops.wkv_layout).
// Returns the cudaError_t of the launch.
extern "C" int wkv_f32(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* out, void* s_fin, int B, int H, int T, int K,
                       int V, int lanes, int warps, void* stream) {
  if (B < 1 || H < 1 || T < 1 || K < 1 || K > kWidth || V < 1 ||
      V > kWidth || (lanes != 4 && lanes != 8 && lanes != 16) ||
      4 * lanes < K || warps < 1 || warps > kMaxWarps ||
      warps * (128 / lanes) > kWidth)
    return cudaErrorInvalidValue;
  const int cols = warps * (128 / lanes);  // columns a block
  const int splits = (V + cols - 1) / cols;
  const long long blocks = static_cast<long long>(B) * H * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && V % 4 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(v) && aligned16(logw) &&
                   aligned16(s0) && aligned16(s_fin);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* of = static_cast<float*>(out);
  auto* tf = static_cast<float*>(s_fin);
  const auto n = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 4)
    launch<4>(vec, n, warps, rf, kf, vf, wf, uf, sf, of, tf, H, T, K, V,
              splits, s);
  else if (lanes == 8)
    launch<8>(vec, n, warps, rf, kf, vf, wf, uf, sf, of, tf, H, T, K, V,
              splits, s);
  else
    launch<16>(vec, n, warps, rf, kf, vf, wf, uf, sf, of, tf, H, T, K, V,
               splits, s);
  return static_cast<int>(cudaGetLastError());
}
