// Selective-SSM (Mamba) scan for Hopper (sm_90a), in f32:
//   s[d, n] <- exp(dt_t[d] * log_a[d, n]) * s[d, n] + (dt_t[d] * u_t[d]) * b_t[n]
//   y_t[d]  =  sum_n s[d, n] * c_t[n]
// over u, dt (B, T, Di), b, c (B, T, N), log_a (Di, N) and the initial
// state s0 (B, Di, N); writes y (B, T, Di) and the final state s_fin
// (B, Di, N).
//
// Replaces the Pallas TPU kernel `ssm_scan` in src/repro/kernels/ssm_scan.py
// (pallas_call at line 71). That kernel runs a grid (B, Di/BD, T/C) with
// the chunk axis innermost and sequential, keeping a (BD, N) state tile in
// VMEM scratch across the chunks. Here the token loop runs inside the
// block and the state stays in registers for the whole sequence. The decay
// is per (d, n), so channels are independent.
//
// Bound: memory. The function reads u, dt once, b, c once, log_a once and
// s0 once and writes y and s_fin once: 4 * (3*B*T*Di + 2*B*T*N + Di*N +
// 2*B*Di*N) bytes, about 6.8 MB at the hymba-1.5b prefill shape (B 4,
// T 32, Di 3200, N 16; 2.0 us at 3.35 TB/s) and 2.0 MB at decode (T 1,
// the state read and written; 0.6 us). Its arithmetic, about 7 operations
// (one an exp) per (token, d, n), stays below that. A decay is taken as
// exp2f(dt * log_a * log2 e), log_a scaled once when it is loaded.
//
// Design. A channel's N states are spread over LANES neighbouring lanes,
// 4 a lane, so the (Di, N) rows of s0, log_a and s_fin move as 16-byte
// vectors, a warp over 32 / LANES whole neighbouring rows. y_t[d] is the
// sum of the LANES lanes' partial sums, taken for kGroup = 4 tokens at
// once by a butterfly of __shfl_xor_sync in a fixed order (3 shuffles for
// 4 tokens at LANES 4, one token's y left on each lane), so no token
// waits on its own shuffles before the next computes; a tile's last
// T % 4 tokens go one at a time (decode's one token too). A block holds
// `channels` channels of one batch row (ops.ssm_scan_layout: 32 channels
// of 4 lanes, 400 blocks, at the serve shape) and stages kTile tokens of
// its u and dt columns and of b and c in shared memory with 16-byte
// cp.async copies (4-byte ones where Di, N or a base is not 16-byte
// aligned), two tiles in flight, the first issued before the state is
// read: no device-memory load is left inside the token loop. A Di that is
// not a multiple of the block is masked, never padded. The plain version
// (repro_torch/kernels/ref.py, `ssm_scan_ref`) sums over n in another
// order, so the two agree to a stated tolerance.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;       // tokens a stage holds
constexpr int kThreads = 128;   // threads a block at most
constexpr int kGroup = 4;       // tokens whose sums are combined at once
constexpr float kLog2e = 1.44269504088896341f;

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

// One tile of kTile tokens: the block's columns of u and dt, and b and c,
// padded to 4 * LANES values a row (the padding zero).
template <int LANES>
struct __align__(16) Stage {
  float u[kTile][kThreads / LANES];
  float dt[kTile][kThreads / LANES];
  float b[kTile][4 * LANES];
  float c[kTile][4 * LANES];
};

// Issue the copies of tokens [t0, t0 + nt) of batch row bi into `st`.
template <int LANES, bool VEC>
__device__ __forceinline__ void stage_tile(
    Stage<LANES>& st, const float* __restrict__ u,
    const float* __restrict__ dt, const float* __restrict__ b,
    const float* __restrict__ c, long long bi, int T, int Di, int N, int d0,
    int nc, int t0, int nt) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long row0 = bi * T + t0;
  if (VEC) {
    const int dq = nc / 4, nq = N / 4;
    for (int e = tid; e < nt * dq; e += nthreads) {
      const int tt = e / dq, q = e - tt * dq;
      const long long g = (row0 + tt) * Di + d0 + 4 * q;
      cp16(&st.u[tt][4 * q], u + g);
      cp16(&st.dt[tt][4 * q], dt + g);
    }
    for (int e = tid; e < nt * nq; e += nthreads) {
      const int tt = e / nq, q = e - tt * nq;
      const long long g = (row0 + tt) * N + 4 * q;
      cp16(&st.b[tt][4 * q], b + g);
      cp16(&st.c[tt][4 * q], c + g);
    }
  } else {
    for (int e = tid; e < nt * nc; e += nthreads) {
      const int tt = e / nc, i = e - tt * nc;
      const long long g = (row0 + tt) * Di + d0 + i;
      cp4(&st.u[tt][i], u + g);
      cp4(&st.dt[tt][i], dt + g);
    }
    for (int e = tid; e < nt * N; e += nthreads) {
      const int tt = e / N, i = e - tt * N;
      const long long g = (row0 + tt) * N + i;
      cp4(&st.b[tt][i], b + g);
      cp4(&st.c[tt][i], c + g);
    }
  }
}

// G tokens from tile row g on: this lane's states (la: log_a in base 2)
// and its share of y, then the sum of y over the channel's LANES lanes,
// for all G tokens at once (max(1, G / LANES) tokens' y a lane; past that
// the lanes that share a sum write it once). y points at token g's y of
// this channel.
template <int G, int LANES>
__device__ __forceinline__ void tokens(const Stage<LANES>& S, int g, int ch,
                                       int nl, const float (&la)[4],
                                       float (&s)[4], float* y, bool live,
                                       int Di) {
  float acc[G];
  const int n0 = 4 * nl;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int tt = g + q;
    const float dtv = S.dt[tt][ch];
    const float x = dtv * S.u[tt][ch];
    const float4 b4 = *reinterpret_cast<const float4*>(&S.b[tt][n0]);
    const float4 c4 = *reinterpret_cast<const float4*>(&S.c[tt][n0]);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
    float o = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = fmaf(exp2f(dtv * la[i]), s[i], x * bb[i]);
      o = fmaf(s[i], cc[i], o);
    }
    acc[q] = o;
  }
  int first = 0;
  butterfly<LANES / 2, G>(acc, nl, first);
  constexpr int kSums = LANES < G ? G / LANES : 1;
  constexpr int kShared = LANES > G ? LANES / G - 1 : 0;
  if (!live || (nl & kShared) != 0) return;
#pragma unroll
  for (int i = 0; i < kSums; ++i)
    y[static_cast<long long>(first + i) * Di] = acc[i];
}

// LANES: lanes a channel (1, 2, 4, 8 or 16; 4 * LANES >= N). VEC: Di and
// N multiples of 4 and every base 16-byte aligned.
template <int LANES, bool VEC>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ log_a,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s_fin, int T, int Di, int N,
                int channels) {
  constexpr int kStates = 4 * LANES;  // padded N
  __shared__ Stage<LANES> st[2];
  const long long bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int ch = tid / LANES, nl = tid % LANES;
  const int d0 = blockIdx.x * channels;
  const int nc = min(channels, Di - d0);
  const int d = d0 + ch;
  const bool live = ch < nc;
  const int n0 = 4 * nl;
  const int ntiles = (T + kTile - 1) / kTile;

  // zero the padding of b and c in both stages (never a copy's
  // destination)
  for (int e = tid; e < 2 * kTile * (kStates - N); e += blockDim.x) {
    const int s = e / (kTile * (kStates - N));
    const int rest = e - s * kTile * (kStates - N);
    const int tt = rest / (kStates - N), i = N + rest % (kStates - N);
    st[s].b[tt][i] = 0.0f;
    st[s].c[tt][i] = 0.0f;
  }
  stage_tile<LANES, VEC>(st[0], u, dt, b, c, bi, T, Di, N, d0, nc, 0,
                         min(kTile, T));
  commit();
  if (ntiles > 1)
    stage_tile<LANES, VEC>(st[1], u, dt, b, c, bi, T, Di, N, d0, nc, kTile,
                           min(kTile, T - kTile));
  commit();

  // the state and log_a rows (log_a in base 2, so a decay is one exp2f),
  // while the copies fly
  float s[4], la[4];
  const long long srow = (bi * Di + d) * N + n0;
  const long long arow = static_cast<long long>(d) * N + n0;
  if (VEC) {
    const bool on = live && n0 < N;
    const float4 x = on ? *reinterpret_cast<const float4*>(s0 + srow)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = on ? *reinterpret_cast<const float4*>(log_a + arow)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[0] = x.x, s[1] = x.y, s[2] = x.z, s[3] = x.w;
    la[0] = a.x * kLog2e, la[1] = a.y * kLog2e, la[2] = a.z * kLog2e,
    la[3] = a.w * kLog2e;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool on = live && n0 + i < N;
      s[i] = on ? s0[srow + i] : 0.0f;
      la[i] = on ? log_a[arow + i] * kLog2e : 0.0f;
    }
  }

  for (int ti = 0; ti < ntiles; ++ti) {
    Stage<LANES>& S = st[ti & 1];
    const int t0 = ti * kTile, nt = min(kTile, T - t0);
    wait_all_but_newest();  // tile ti has landed (this thread's copies)
    __syncthreads();        // (everyone's)
    float* y_tile = y + (bi * T + t0) * Di + d;
    int g = 0;
    for (; g + kGroup <= nt; g += kGroup)
      tokens<kGroup, LANES>(S, g, ch, nl, la, s, y_tile + g * Di, live, Di);
    for (; g < nt; ++g)  // the tile's last tokens, one at a time
      tokens<1, LANES>(S, g, ch, nl, la, s, y_tile + g * Di, live, Di);
    __syncthreads();  // the stage is consumed
    if (ti + 2 < ntiles)
      stage_tile<LANES, VEC>(S, u, dt, b, c, bi, T, Di, N, d0, nc,
                             t0 + 2 * kTile, min(kTile, T - t0 - 2 * kTile));
    commit();
  }

  if (VEC) {
    if (live && n0 < N)
      *reinterpret_cast<float4*>(s_fin + srow) =
          make_float4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (live && n0 + i < N) s_fin[srow + i] = s[i];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int LANES>
void launch(bool vec, dim3 grid, int channels, const float* u,
            const float* dt, const float* b, const float* c, const float* la,
            const float* s0, float* y, float* s_fin, int T, int Di, int N,
            cudaStream_t stream) {
  const int threads = channels * LANES;
  if (vec)
    ssm_scan_kernel<LANES, true><<<grid, threads, 0, stream>>>(
        u, dt, b, c, la, s0, y, s_fin, T, Di, N, channels);
  else
    ssm_scan_kernel<LANES, false><<<grid, threads, 0, stream>>>(
        u, dt, b, c, la, s0, y, s_fin, T, Di, N, channels);
}

}  // namespace

// (u, dt, b, c, log_a, s0, y, s_fin, B, T, Di, N, lanes, channels, stream);
// every array f32 and contiguous in the layout above, y and s_fin not
// aliasing any input. `lanes` (1, 2, 4, 8 or 16, with 4 * lanes >= N)
// share a channel's states; a block holds `channels` channels (a multiple
// of 4, channels * lanes a multiple of 32 and at most 128;
// ops.ssm_scan_layout). Returns the cudaError_t of the launch.
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* b,
                            const void* c, const void* log_a, const void* s0,
                            void* y, void* s_fin, int B, int T, int Di, int N,
                            int lanes, int channels, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || Di < 1 || N < 1 || N > 64 ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8 &&
       lanes != 16) ||
      4 * lanes < N || channels < 4 || channels % 4 != 0 ||
      channels * lanes > kThreads || (channels * lanes) % 32 != 0)
    return cudaErrorInvalidValue;
  const bool vec = Di % 4 == 0 && N % 4 == 0 && aligned16(u) &&
                   aligned16(dt) && aligned16(b) && aligned16(c) &&
                   aligned16(log_a) && aligned16(s0) && aligned16(s_fin);
  const auto* uf = static_cast<const float*>(u);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  const auto* lf = static_cast<const float*>(log_a);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* tf = static_cast<float*>(s_fin);
  const dim3 grid(static_cast<unsigned>((Di + channels - 1) / channels),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      launch<1>(vec, grid, channels, uf, df, bf, cf, lf, sf, yf, tf, T, Di, N,
                s);
      break;
    case 2:
      launch<2>(vec, grid, channels, uf, df, bf, cf, lf, sf, yf, tf, T, Di, N,
                s);
      break;
    case 4:
      launch<4>(vec, grid, channels, uf, df, bf, cf, lf, sf, yf, tf, T, Di, N,
                s);
      break;
    case 8:
      launch<8>(vec, grid, channels, uf, df, bf, cf, lf, sf, yf, tf, T, Di, N,
                s);
      break;
    default:
      launch<16>(vec, grid, channels, uf, df, bf, cf, lf, sf, yf, tf, T, Di,
                 N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
