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
// thread: one thread per (b, d) holds its N state values and its row of
// log_a in registers for the whole sequence. The decay is per (d, n), so
// channels are independent and need no communication.
//
// Bound: memory. The function reads u, dt once, b, c once, log_a once and
// s0 once and writes y and s_fin once: 4 * (3*B*T*Di + 2*B*T*N + Di*N +
// 2*B*Di*N) bytes, about 6.8 MB at the hymba-1.5b prefill shape (B 4,
// T 32, Di 3200, N 16; 2.0 us at 3.35 TB/s) and 2.0 MB at decode (T 1,
// the state read and written; 0.6 us). Its arithmetic, about 7 operations
// (one an exp) per (token, d, n), stays below that. Design: a block of
// 128 channels of one batch row stages kTile tokens of b and c in shared
// memory (one sync per tile) and every thread reads them as broadcasts;
// u_t, dt_t and y_t are read and written by neighbouring threads at
// neighbouring addresses. A Di that is not a multiple of the block is
// masked (the threads past Di load and sync but read and write nothing),
// never padded. B * ceil(Di / 128) blocks: 100 at the serve shape. The
// products and sums use __fmul_rn / __fadd_rn (no fused multiply-add),
// and y sums over n in order; the plain version (repro_torch/kernels/
// ref.py, `ssm_scan_ref`) reduces over n in another order, so the two
// agree to a stated tolerance.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // tokens of b and c staged at a time
constexpr int kThreads = 128;  // channels per block

// NMAX: compile-time bound on N (16, 32 or 64), so the state and log_a
// rows are arrays of registers indexed only by unrolled constants.
template <int NMAX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ b, const float* __restrict__ c,
                const float* __restrict__ log_a,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s_fin, int T, int Di, int N) {
  __shared__ float sb[kTile][NMAX];
  __shared__ float sc[kTile][NMAX];
  const long long bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Di;
  const long long srow = (bi * Di + d) * N;

  float s[NMAX], la[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const bool on = live && i < N;
    la[i] = on ? log_a[static_cast<long long>(d) * N + i] : 0.0f;
    s[i] = on ? s0[srow + i] : 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < nt * N; e += kThreads) {
      const int tt = e / N, i = e % N;
      const long long g = (bi * T + t0 + tt) * N + i;
      sb[tt][i] = b[g];
      sc[tt][i] = c[g];
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < nt; ++tt) {
        const long long g = (bi * T + t0 + tt) * Di + d;
        const float dtv = dt[g];
        const float x = __fmul_rn(dtv, u[g]);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NMAX; ++i) {
          if (i < N) {
            const float decay = expf(__fmul_rn(dtv, la[i]));
            s[i] = __fadd_rn(__fmul_rn(decay, s[i]), __fmul_rn(x, sb[tt][i]));
            acc = __fadd_rn(acc, __fmul_rn(s[i], sc[tt][i]));
          }
        }
        y[g] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      if (i < N) s_fin[srow + i] = s[i];
  }
}

template <int NMAX>
void launch(const float* u, const float* dt, const float* b, const float* c,
            const float* la, const float* s0, float* y, float* s_fin, int B,
            int T, int Di, int N, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((Di + kThreads - 1) / kThreads),
            static_cast<unsigned>(B));
  ssm_scan_kernel<NMAX><<<grid, kThreads, 0, stream>>>(u, dt, b, c, la, s0,
                                                       y, s_fin, T, Di, N);
}

}  // namespace

// (u, dt, b, c, log_a, s0, y, s_fin, B, T, Di, N, stream); every array
// f32 and contiguous in the layout above, y and s_fin not aliasing any
// input. Returns the cudaError_t of the launch.
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* b,
                            const void* c, const void* log_a, const void* s0,
                            void* y, void* s_fin, int B, int T, int Di, int N,
                            void* stream) {
  if (B < 1 || B > 65535 || T < 1 || Di < 1 || N < 1 || N > 64)
    return cudaErrorInvalidValue;
  const auto* uf = static_cast<const float*>(u);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(c);
  const auto* lf = static_cast<const float*>(log_a);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* tf = static_cast<float*>(s_fin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    launch<16>(uf, df, bf, cf, lf, sf, yf, tf, B, T, Di, N, s);
  else if (N <= 32)
    launch<32>(uf, df, bf, cf, lf, sf, yf, tf, B, T, Di, N, s);
  else
    launch<64>(uf, df, bf, cf, lf, sf, yf, tf, B, T, Di, N, s);
  return static_cast<int>(cudaGetLastError());
}
