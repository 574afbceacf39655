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
// inside one thread block per (b, h) and the state stays in registers for
// the whole sequence: thread j owns column S[:, j] (K <= 64 f32 values),
// so the recurrence above is evaluated token by token and no pair tile is
// formed. The chunked and the sequential forms compute the same function;
// their float rounding differs, and the plain version
// (repro_torch/kernels/ref.py, `wkv_ref`) uses the sequential form with a
// reduction over k in another order, so the two agree to a stated
// tolerance, not bit for bit.
//
// Bound: memory. The function reads r, k, logw, v once, u once and s0
// once and writes out and s_fin once: 4 * (B*H*T*(3K + 2V) + H*K + 2*B*H*K*V)
// bytes, about 9.4 MB at the rwkv6-1.6b prefill shape (B 4, H 32, T 32,
// K = V = 64; 2.8 us at 3.35 TB/s) and 4.4 MB at decode (T 1, the state
// read and written; 1.3 us). Its arithmetic, 7 flops per (token, k, v),
// is 117 MFLOP at the prefill shape (1.7 us at 67 TFLOP/s f32), below the
// memory time. Design: a block stages kTile tokens of r, k, exp(logw) and
// v in shared memory with coalesced loads (one sync per tile, not per
// token); every thread then reads the staged k-vectors as broadcasts and
// its own v_t[j], and writes o_t[j] (neighbouring threads, neighbouring
// addresses). The state is read from s0 once and written to s_fin once.
// B*H blocks of max(32, V) threads: 128 blocks at the serve shape, which
// leaves most of the card idle; a later version may split V over blocks.
// Products and sums use __fmul_rn / __fadd_rn (no fused multiply-add).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // tokens staged in shared memory at a time

// KMAX: compile-time bound on K (16, 32 or 64), so the state column is an
// array of registers indexed only by unrolled constants.
template <int KMAX>
__global__ void __launch_bounds__(64)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ out, float* __restrict__ s_fin, int H, int T,
           int K, int V) {
  __shared__ float sr[kTile][KMAX];
  __shared__ float sk[kTile][KMAX];
  __shared__ float sw[kTile][KMAX];
  __shared__ float sv[kTile][64];
  __shared__ float su[KMAX];
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const int j = threadIdx.x;  // the state column this thread owns
  const bool live = j < V;
  const long long base_k = bh * T * K;
  const long long base_v = bh * T * V;
  const float* s_in = s0 + bh * K * V;

  float s[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    s[i] = (live && i < K) ? s_in[static_cast<long long>(i) * V + j] : 0.0f;
  for (int i = j; i < K; i += blockDim.x) su[i] = u[h * K + i];

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = j; e < nt * K; e += blockDim.x) {
      const int tt = e / K, i = e % K;
      const long long g = base_k + static_cast<long long>(t0 + tt) * K + i;
      sr[tt][i] = r[g];
      sk[tt][i] = k[g];
      sw[tt][i] = expf(logw[g]);
    }
    for (int e = j; e < nt * V; e += blockDim.x) {
      const int tt = e / V, i = e % V;
      sv[tt][i] = v[base_v + static_cast<long long>(t0 + tt) * V + i];
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < nt; ++tt) {
        const float vt = sv[tt][j];
        float o = 0.0f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < K) {
            const float kv = __fmul_rn(sk[tt][i], vt);
            o = __fadd_rn(o, __fmul_rn(sr[tt][i],
                                       __fadd_rn(s[i], __fmul_rn(su[i], kv))));
            s[i] = __fadd_rn(__fmul_rn(sw[tt][i], s[i]), kv);
          }
        }
        out[base_v + static_cast<long long>(t0 + tt) * V + j] = o;
      }
    }
  }
  if (live) {
    float* s_out = s_fin + bh * K * V;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) s_out[static_cast<long long>(i) * V + j] = s[i];
  }
}

template <int KMAX>
void launch(const float* r, const float* k, const float* v, const float* lw,
            const float* u, const float* s0, float* out, float* s_fin,
            long long BH, int H, int T, int K, int V, cudaStream_t stream) {
  const int threads = V <= 32 ? 32 : 64;
  wkv_kernel<KMAX><<<static_cast<unsigned>(BH), threads, 0, stream>>>(
      r, k, v, lw, u, s0, out, s_fin, H, T, K, V);
}

}  // namespace

// (r, k, v, logw, u, s0, out, s_fin, B, H, T, K, V, stream); every array
// f32 and contiguous in the layout above, out and s_fin not aliasing any
// input. Returns the cudaError_t of the launch.
extern "C" int wkv_f32(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, const void* s0,
                       void* out, void* s_fin, int B, int H, int T, int K,
                       int V, void* stream) {
  if (B < 1 || H < 1 || T < 1 || K < 1 || K > 64 || V < 1 || V > 64 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* of = static_cast<float*>(out);
  auto* tf = static_cast<float*>(s_fin);
  const long long BH = static_cast<long long>(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 16)
    launch<16>(rf, kf, vf, wf, uf, sf, of, tf, BH, H, T, K, V, s);
  else if (K <= 32)
    launch<32>(rf, kf, vf, wf, uf, sf, of, tf, BH, H, T, K, V, s);
  else
    launch<64>(rf, kf, vf, wf, uf, sf, of, tf, BH, H, T, K, V, s);
  return static_cast<int>(cudaGetLastError());
}
