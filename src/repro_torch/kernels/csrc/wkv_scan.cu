// RWKV-6 WKV scan kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/wkv_scan.py::wkv_scan_pallas.  Per (batch, head)
// the (dk, dv) state S runs through the Finch recurrence from a zero state,
//
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// and the kernel writes y (B, S, H, dv), the final state (B, H, dk, dv) and the
// state at the entry of every chunk (B, nc, H, dk, dv), the checkpoints the
// backward pass restarts from.
//
// What bounds it on this card: at the LM's prefill shapes (B=4, S=1024, H=48,
// dk=dv=64) it reads w, k, v, r once (201 MB) and writes y and the chunk
// states (104 MB) for 5.6 GFLOP, so bytes and FP32 operations each need about
// 0.09 ms.  But the recurrence is sequential in t and B*H = 192 heads is less
// than two blocks per SM, so what bounds this simple kernel in practice is
// the latency of one step times S.
//
// Design.  The TPU kernel walks the sequence as a sequential grid axis with
// the state in VMEM; Hopper blocks run in no order, so here one block owns one
// (batch, head) and loops over t itself.  Thread j holds column S[:, j] in
// registers (dk is a template parameter, so the column is dk registers).
// w_t, k_t and r_t are dk contiguous floats read by every thread: a tile of
// kTile steps of them (and of v) is staged in shared memory with coalesced
// loads, so one pair of barriers serves kTile steps and the step loop reads
// broadcasts from shared memory.  y_t[j] is summed into four partial sums to
// shorten its dependency chain.  y and the states are written coalesced
// (neighbouring threads, neighbouring columns).  No tensor cores: the
// per-step work is a rank-1 update and a vector-matrix product, FP32 FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // time steps staged in shared memory at once
constexpr int kMaxDv = 128;   // one thread per value column

template <int DK>
__global__ void __launch_bounds__(kMaxDv)
wkv_kernel(const float* __restrict__ w, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ r,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_fin, float* __restrict__ s_bounds, int S,
           int H, int dv, int chunk) {
  __shared__ float w_s[kTile][DK];
  __shared__ float k_s[kTile][DK];
  __shared__ float r_s[kTile][DK];
  __shared__ float v_s[kTile][kMaxDv];
  __shared__ float u_s[DK];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j = threadIdx.x;
  const bool active = j < dv;
  const int nc = S / chunk;
  const long long row = static_cast<long long>(H) * DK;      // w/k/r step stride
  const long long vrow = static_cast<long long>(H) * dv;     // v/y step stride
  const long long base = (static_cast<long long>(b) * S * H + h) * DK;
  const long long vbase = (static_cast<long long>(b) * S * H + h) * dv;
  const long long plane = static_cast<long long>(DK) * dv;

  for (int i = j; i < DK; i += blockDim.x) u_s[i] = u[h * DK + i];
  float st[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = S - t0 < kTile ? S - t0 : kTile;
    __syncthreads();   // the previous tile is consumed
    for (int e = j; e < steps * DK; e += blockDim.x) {
      const int tt = e / DK, i = e % DK;
      const long long off = base + (t0 + tt) * row + i;
      w_s[tt][i] = w[off];
      k_s[tt][i] = k[off];
      r_s[tt][i] = r[off];
    }
    for (int e = j; e < steps * dv; e += blockDim.x) {
      const int tt = e / dv, c = e % dv;
      v_s[tt][c] = v[vbase + (t0 + tt) * vrow + c];
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      if (t % chunk == 0) {
        float* dst = s_bounds +
            ((static_cast<long long>(b) * nc + t / chunk) * H + h) * plane + j;
#pragma unroll
        for (int i = 0; i < DK; ++i) dst[i * dv] = st[i];
      }
      const float vj = v_s[tt][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < DK; i += 4) {
        float kv = k_s[tt][i] * vj;
        acc0 = fmaf(r_s[tt][i], fmaf(u_s[i], kv, st[i]), acc0);
        st[i] = fmaf(w_s[tt][i], st[i], kv);
        kv = k_s[tt][i + 1] * vj;
        acc1 = fmaf(r_s[tt][i + 1], fmaf(u_s[i + 1], kv, st[i + 1]), acc1);
        st[i + 1] = fmaf(w_s[tt][i + 1], st[i + 1], kv);
        kv = k_s[tt][i + 2] * vj;
        acc2 = fmaf(r_s[tt][i + 2], fmaf(u_s[i + 2], kv, st[i + 2]), acc2);
        st[i + 2] = fmaf(w_s[tt][i + 2], st[i + 2], kv);
        kv = k_s[tt][i + 3] * vj;
        acc3 = fmaf(r_s[tt][i + 3], fmaf(u_s[i + 3], kv, st[i + 3]), acc3);
        st[i + 3] = fmaf(w_s[tt][i + 3], st[i + 3], kv);
      }
      y[vbase + t * vrow + j] = (acc0 + acc1) + (acc2 + acc3);
    }
  }
  if (active) {
    float* dst = s_fin + (static_cast<long long>(b) * H + h) * plane + j;
#pragma unroll
    for (int i = 0; i < DK; ++i) dst[i * dv] = st[i];
  }
}

template <int DK>
int launch(const float* w, const float* k, const float* v, const float* r,
           const float* u, float* y, float* s_fin, float* s_bounds, int B,
           int S, int H, int dv, int chunk, cudaStream_t stream) {
  const int threads = (dv + 31) / 32 * 32;
  wkv_kernel<DK><<<B * H, threads, 0, stream>>>(w, k, v, r, u, y, s_fin,
                                                s_bounds, S, H, dv, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, k, r (B, S, H, dk), v (B, S, H, dv), u (H, dk): contiguous float32.
// y (B, S, H, dv), s_fin (B, H, dk, dv), s_bounds (B, S / chunk, H, dk, dv):
// contiguous float32 outputs.  dk in {8, 16, 32, 64}, 1 <= dv <= 128, chunk
// divides S.  Returns the cudaError_t of the launch.
extern "C" int repro_wkv_scan_f32(const float* w, const float* k,
                                  const float* v, const float* r,
                                  const float* u, float* y, float* s_fin,
                                  float* s_bounds, int B, int S, int H, int dk,
                                  int dv, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dv < 1 || dv > kMaxDv || chunk < 1 ||
      S % chunk != 0 || static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 8: return launch<8>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, st);
    case 16: return launch<16>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, st);
    case 32: return launch<32>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, st);
    case 64: return launch<64>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
