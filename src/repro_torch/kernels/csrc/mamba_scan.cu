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
// (302 MB), 0.25 ms at the HBM rate, and it takes B*S*d*s = 1.07e9
// exponentials.  The exponential is the special-function unit's ex2 (MUFU.EX2),
// 16 per clock per SM: 1.07e9 of them need 0.26 ms at the H100's 1.98 GHz
// maximum SM clock.  Bytes and the MUFU rate bound it alike.
//
// Design.  The TPU kernel keeps a (d_blk, s) state tile in VMEM across a
// sequential grid walk over sequence chunks; Hopper blocks run in no order, so
// each thread owns one channel, holds its s states in registers (s is a
// template parameter) and loops over t itself.  B*d = 65536 channels fill the
// card.
//   - Each exponential is one MUFU op: log2(e) is folded into A once,
//     A2 = -exp(A_log) log2(e), and a step's decay is ex2.approx.ftz(dt A2)
//     (relative error about 2^-22; an accurate expf is a range reduction
//     around the same MUFU op, some 8-10 instructions).  That leaves about
//     five issue slots per state and step: the ex2, its argument, the two
//     FMAs of the update and output, and dt x B's multiply.
//   - B_t and C_t (s floats per step, shared by every channel of the batch
//     row) are read as float4 broadcasts from shared memory.
//   - Everything a tile of kTile steps reads (B, C, and the block's channels
//     of dt and x, which neighbouring threads copy from neighbouring
//     addresses) comes in with cp.async into one of two buffers while the
//     block steps through the other, so the loads hide behind a tile of work
//     and the registers hold only the state and A2; small blocks (kThreads)
//     then keep many warps on each SM.
// Channels past d (a ragged last block) step through a copy of the last
// channel and store nothing.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kTile = 16;      // time steps per staged tile (two in flight)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit: one MUFU.EX2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
mamba_kernel(const float* __restrict__ dt, const float* __restrict__ x,
             const float* __restrict__ Bm, const float* __restrict__ Cm,
             const float* __restrict__ A_log, const float* __restrict__ Dp,
             float* __restrict__ y, float* __restrict__ h_fin,
             float* __restrict__ h_bounds, int S, int d, int chunk) {
  static_assert(NS % 4 == 0, "float4 reads of B_t and C_t");
  __shared__ __align__(16) float bc_s[2][2][kTile * NS];   // [buffer][B, C][step, n]
  __shared__ float dx_s[2][2][kTile][kThreads];             // [buffer][dt, x][step, channel]

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool active = c < d;
  const int ch = active ? c : d - 1;   // channels past d step through a copy
  const int nc = S / chunk;

  float A2[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A2[n] = -expf(A_log[static_cast<long long>(ch) * NS + n]) * kLog2e;
    h[n] = 0.f;
  }
  const float Dc = Dp[ch];
  const long long row0 = static_cast<long long>(b) * S;     // (b, t=0) row

  // B_t and C_t of the tile (all threads), and this thread's channel of dt
  // and x (read back by this thread only)
  auto stage = [&](int t0, int buf) {
    const int steps = S - t0 < kTile ? S - t0 : kTile;
    const long long off = (row0 + t0) * NS;
    for (int e = tid; e < steps * NS; e += kThreads) {
      async_copy::copy<4>(&bc_s[buf][0][e], Bm + off + e);
      async_copy::copy<4>(&bc_s[buf][1][e], Cm + off + e);
    }
    const long long at = (row0 + t0) * d + ch;
    for (int tt = 0; tt < steps; ++tt) {
      async_copy::copy<4>(&dx_s[buf][0][tt][tid], dt + at + static_cast<long long>(tt) * d);
      async_copy::copy<4>(&dx_s[buf][1][tt][tid], x + at + static_cast<long long>(tt) * d);
    }
    async_copy::commit();
  };
  auto store_state = [&](float* dst) {
    float4* d4 = reinterpret_cast<float4*>(dst + static_cast<long long>(c) * NS);
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      d4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  };

  const int ntiles = (S + kTile - 1) / kTile;
  int next_bound = 0, bound = 0;     // the next chunk entry and its index
  stage(0, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int t0 = n * kTile;
    const int buf = n & 1;
    const int steps = S - t0 < kTile ? S - t0 : kTile;
    if (n + 1 < ntiles) {
      stage(t0 + kTile, buf ^ 1);    // that buffer was consumed in tile n - 1
    } else {
      async_copy::commit();          // an empty group: tile n is then the older one
    }
    async_copy::wait<1>();
    __syncthreads();                 // tile n visible to every thread

    const float4* b4 = reinterpret_cast<const float4*>(&bc_s[buf][0][0]);
    const float4* c4 = reinterpret_cast<const float4*>(&bc_s[buf][1][0]);
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      if (t == next_bound) {
        if (active) store_state(h_bounds + (static_cast<long long>(b) * nc + bound) * d * NS);
        next_bound += chunk;
        ++bound;
      }
      const float dtv = dx_s[buf][0][tt][tid];
      const float xv = dx_s[buf][1][tt][tid];
      const float dtx = dtv * xv;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int q = 0; q < NS / 4; ++q) {
        const float4 bq = b4[tt * (NS / 4) + q], cq = c4[tt * (NS / 4) + q];
        const float bx[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cx[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          h[i] = fmaf(ex2(dtv * A2[i]), h[i], dtx * bx[e]);
          if (e & 1) {
            acc1 = fmaf(h[i], cx[e], acc1);
          } else {
            acc0 = fmaf(h[i], cx[e], acc0);
          }
        }
      }
      if (active) y[(row0 + t) * d + c] = fmaf(Dc, xv, acc0 + acc1);
    }
    __syncthreads();                 // buffer `buf` consumed
  }
  if (active) store_state(h_fin + static_cast<long long>(b) * d * NS);
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
// float32 outputs (16-byte aligned).  s in {4, 8, 16, 32, 64} (the wrapper
// pads other state sizes with zero columns of B and C, and scans more than 64
// states in groups), B <= 65535, chunk divides S.  Returns the cudaError_t of the launch.
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
    case 64: return launch<64>(dt, x, Bm, Cm, A_log, D, y, h_fin, h_bounds, B, S, d, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
