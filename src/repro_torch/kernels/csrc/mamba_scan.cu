// Mamba selective-scan kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mamba_scan.py::mamba_scan_pallas.  Per batch row
// and channel d, the s-wide state h runs from zero through
//
//     h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,     A = -exp(A_log[d])
//     y_t = h_t . C_t + D x_t
//
// and the kernel writes y (B, S, d), the final state (B, d, s) and the state at
// the entry of every chunk (B, nc, d, s), the checkpoints the backward pass
// restarts from.
//
// What bounds it on this card: at the LM's prefill shapes (B=4, S=1024,
// d=16384, s=16) it reads dt and x (537 MB) and writes y and the chunk states
// (302 MB), about 0.25 ms at the HBM rate, and it takes B*S*d*s = 1.07e9
// exponentials, about as long again on the FP32 pipes (expf is a range
// reduction around one MUFU.EX2).  The sequential walk over S is spread over
// B*d = 65536 independent channels, enough threads to fill the card.
//
// Design.  The TPU kernel keeps a (d_blk, s) state tile in VMEM across a
// sequential grid walk over sequence chunks; Hopper blocks run in no order, so
// here each thread owns one channel, holds its s states and its row of A in
// registers (s is a template parameter) and loops over t itself.  B_t and C_t
// (s floats per step, shared by every channel of the batch row) are staged in
// shared memory a tile of kTile steps at a time; the tile's dt and x, which
// neighbouring threads read at neighbouring addresses, are loaded into
// registers before the tile's steps run, so kTile loads are in flight at once
// instead of one per step.  Channels past d (a ragged last block) only help
// with the staging.  expf, not __expf: __expf (one MUFU.EX2 on a scaled
// argument) was not tried in this version; the tests hold the kernel at 1e-4
// against the plain version, which uses torch.exp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTile = 16;      // time steps staged at once

template <int NS>
__global__ void __launch_bounds__(kThreads)
mamba_kernel(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ Bm, const float* __restrict__ Cm,
             const float* __restrict__ A_log, const float* __restrict__ Dp,
             float* __restrict__ y, float* __restrict__ h_fin,
             float* __restrict__ h_bounds, int S, int d, int chunk) {
  __shared__ float b_s[kTile * NS];
  __shared__ float c_s[kTile * NS];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < d;
  const int nc = S / chunk;

  float A[NS], h[NS];
  float Dc = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = active ? -expf(A_log[static_cast<long long>(c) * NS + n]) : 0.f;
    h[n] = 0.f;
  }
  if (active) Dc = Dp[c];

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = S - t0 < kTile ? S - t0 : kTile;
    __syncthreads();   // the previous tile is consumed
    const long long bc_base = (static_cast<long long>(b) * S + t0) * NS;
    for (int e = threadIdx.x; e < steps * NS; e += kThreads) {
      b_s[e] = Bm[bc_base + e];
      c_s[e] = Cm[bc_base + e];
    }
    float dt_r[kTile], x_r[kTile];
    const long long base = (static_cast<long long>(b) * S + t0) * d + c;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const bool ok = active && tt < steps;
      dt_r[tt] = ok ? dt[base + static_cast<long long>(tt) * d] : 0.f;
      x_r[tt] = ok ? x[base + static_cast<long long>(tt) * d] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt >= steps) continue;   // a constant index after unrolling
      const int t = t0 + tt;
      if (t % chunk == 0) {
        float4* dst = reinterpret_cast<float4*>(
            h_bounds + ((static_cast<long long>(b) * nc + t / chunk) * d + c) * NS);
#pragma unroll
        for (int q = 0; q < NS / 4; ++q) {
          dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }
      }
      const float dtv = dt_r[tt];
      const float dtx = dtv * x_r[tt];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float a = expf(dtv * A[n]);
        h[n] = fmaf(a, h[n], dtx * b_s[tt * NS + n]);
        acc = fmaf(h[n], c_s[tt * NS + n], acc);
      }
      y[base + static_cast<long long>(tt) * d] = fmaf(Dc, x_r[tt], acc);
    }
  }
  if (active) {
    float4* dst = reinterpret_cast<float4*>(
        h_fin + (static_cast<long long>(b) * d + c) * NS);
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  }
}

template <int NS>
int launch(const float* dt, const float* x, const float* Bm, const float* Cm,
           const float* A_log, const float* D, float* y, float* h_fin,
           float* h_bounds, int B, int S, int d, int chunk,
           cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, B);
  mamba_kernel<NS><<<grid, kThreads, 0, stream>>>(dt, x, Bm, Cm, A_log, D, y,
                                                  h_fin, h_bounds, S, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, x (B, S, d), Bm, Cm (B, S, s), A_log (d, s), D (d): contiguous float32.
// y (B, S, d), h_fin (B, d, s), h_bounds (B, S / chunk, d, s): contiguous
// float32 outputs (16-byte aligned).  s in {4, 8, 16, 32}, B <= 65535, chunk
// divides S.  Returns the cudaError_t of the launch.
extern "C" int repro_mamba_scan_f32(const float* dt, const float* x,
                                    const float* Bm, const float* Cm,
                                    const float* A_log, const float* D,
                                    float* y, float* h_fin, float* h_bounds,
                                    int B, int S, int d, int s, int chunk,
                                    void* stream) {
  if (B < 1 || B > 65535 || S < 1 || d < 1 || chunk < 1 || S % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 4: return launch<4>(dt, x, Bm, Cm, A_log, D, y, h_fin, h_bounds, B, S, d, chunk, st);
    case 8: return launch<8>(dt, x, Bm, Cm, A_log, D, y, h_fin, h_bounds, B, S, d, chunk, st);
    case 16: return launch<16>(dt, x, Bm, Cm, A_log, D, y, h_fin, h_bounds, B, S, d, chunk, st);
    case 32: return launch<32>(dt, x, Bm, Cm, A_log, D, y, h_fin, h_bounds, B, S, d, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
