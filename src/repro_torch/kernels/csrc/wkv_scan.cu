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
// 0.09 ms.  The recurrence is sequential in t, so a kernel is held by one
// step's latency times S unless enough warps run beside it, and then by the
// shared-memory traffic of feeding w_t, k_t, r_t to every thread that holds a
// piece of the state.
//
// Design.  The TPU kernel walks the sequence as a sequential grid axis with
// the state in VMEM; Hopper blocks run in no order, so a block loops over t
// itself.  The columns of S are independent (S_t[:, j] = w_t * S_{t-1}[:, j] +
// k_t v_t[j]), so a block owns one (batch, head, group of kCols columns):
//   - each column's dk rows are split over L = lanes_for(dk) neighbouring
//     threads of a warp, dk / L rows each, and each thread holds those rows of
//     kCpt columns, in registers with its rows of u.  At the prefill shapes
//     that is 8 lanes x 8 rows x 2 columns: 384 blocks of 128 threads, 1,536
//     warps for the card's 528 schedulers;
//   - a thread's state update is one FMA per row and column with no traffic
//     between threads, so the recurrence's critical path is one FMA a step;
//   - a thread's rows are float4 groups lane, lane + L, ..., so the lanes of a
//     column read w_t, k_t and r_t from shared memory as neighbouring float4
//     broadcasts, free of bank conflicts, and each read serves kCpt columns;
//   - y_t[j] is summed over a lane's rows in registers and over the L lanes
//     once per tile: each lane stores its partial sums in shared memory, off
//     the recurrence's path and with no shuffle chain per step.
// Tiles of kTile steps of w, k, r and the block's v columns are copied with
// cp.async (16 bytes at a time where every pointer allows it) into one of
// two buffers while the block steps through the other, so one barrier pair
// per tile serves kTile steps and the copies' latency hides behind the
// previous tile; y leaves once per tile, coalesced.  Chunk-entry states and
// the final state are written by each thread for its rows: neighbouring
// columns, neighbouring addresses.  Ragged column groups (dv not a multiple
// of kCols) step their idle columns on v = 0 and store nothing for them.  No
// tensor cores: a chunked matrix form would need TF32 or bf16, and the
// kernel stays FP32.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kCols = 32;     // value columns per block
constexpr int kLanes = 8;     // threads per column, at most dk / 4
constexpr int kCpt = 2;       // columns per thread
constexpr int kSlots = kCols / kCpt;   // a thread's columns: slot + c * kSlots

// Time steps per staged tile (two in flight): 16, fewer for the wide heads
// (dk 128 and 256), whose tiles would pass the 48 KB of static shared memory.
__host__ __device__ constexpr int tile_steps(int dk) { return dk <= 64 ? 16 : 1024 / dk; }

// Threads per column for a head width: kLanes, fewer where dk / kLanes would
// leave a lane less than one float4 of rows.
constexpr int lanes_for(int dk) { return dk / 4 < kLanes ? dk / 4 : kLanes; }

// One block: (batch, head, group of kCols value columns).  Thread tid is
// lane tid % L of column slot tid / L and holds columns slot + c * kSlots,
// c < kCpt, so one float4 read of w, k, r serves kCpt columns.
template <int DK, int L>
__global__ void __launch_bounds__(L * kSlots)
wkv_kernel(const float* __restrict__ w, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ r,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_fin, float* __restrict__ s_bounds, int S,
           int H, int dv, int chunk, int vec) {
  constexpr int NT = L * kSlots;      // threads
  constexpr int R = DK / L;          // rows per lane
  constexpr int Q = R / 4;           // float4 groups per lane
  constexpr int kTile = tile_steps(DK);
  static_assert(R % 4 == 0 && 32 % L == 0 && NT % 32 == 0 && kCols % 32 == 0,
                "lane split");
  __shared__ __align__(16) float wkr_s[2][3][kTile][DK];   // w, k, r
  __shared__ __align__(16) float v_s[2][kTile][kCols];
  // each lane's partial sum of y_t[j] over its rows; the pitch kCols + 32 / L
  // puts a warp's L lanes x 32 / L column slots on 32 different banks
  __shared__ float y_part[kTile][L][kCols + 32 / L];

  const int groups = (dv + kCols - 1) / kCols;
  const int g = blockIdx.x % groups;
  const int bh = blockIdx.x / groups;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int slot = tid / L;
  const int ncols = dv - g * kCols < kCols ? dv - g * kCols : kCols;
  const int nc = S / chunk;
  const long long row = static_cast<long long>(H) * DK;      // w/k/r step stride
  const long long vrow = static_cast<long long>(H) * dv;     // v/y step stride
  const long long base = (static_cast<long long>(b) * S * H + h) * DK;
  const long long vbase = (static_cast<long long>(b) * S * H + h) * dv + g * kCols;
  const long long plane = static_cast<long long>(DK) * dv;

  // this lane's rows: float4 groups lane + L * q, q < Q, of kCpt columns
  float uu[R], st[kCpt][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uu[4 * q + e] = u[h * DK + 4 * (lane + L * q) + e];
#pragma unroll
      for (int c = 0; c < kCpt; ++c) st[c][4 * q + e] = 0.f;
    }
  }

  // this thread's rows of its columns' states, row-major (dk, dv) at dst
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int c = 0; c < kCpt; ++c) {
      const int col = slot + c * kSlots;
      if (col >= ncols) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[static_cast<long long>(4 * (lane + L * q) + e) * dv + g * kCols + col] =
              st[c][4 * q + e];
        }
      }
    }
  };

  auto stage = [&](int t0, int buf) {
    const int steps = S - t0 < kTile ? S - t0 : kTile;
    const float* src[3] = {w, k, r};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      async_copy::copy_rows(vec, &wkr_s[buf][a][0][0], DK, src[a] + base + t0 * row,
                            row, steps, DK, tid, NT);
    }
    async_copy::copy_rows(vec, &v_s[buf][0][0], kCols, v + vbase + t0 * vrow, vrow,
                          steps, ncols, tid, NT);
    async_copy::commit();
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

    const float4* w4 = reinterpret_cast<const float4*>(&wkr_s[buf][0][0][0]);
    const float4* k4 = reinterpret_cast<const float4*>(&wkr_s[buf][1][0][0]);
    const float4* r4 = reinterpret_cast<const float4*>(&wkr_s[buf][2][0][0]);
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      if (t0 + tt == next_bound) {
        store_state(s_bounds + ((static_cast<long long>(b) * nc + bound) * H + h) * plane);
        next_bound += chunk;
        ++bound;
      }
      float vj[kCpt], acc0[kCpt], acc1[kCpt];
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        // idle columns of a ragged group step on v = 0 and store nothing
        vj[c] = slot + c * kSlots < ncols ? v_s[buf][tt][slot + c * kSlots] : 0.f;
        acc0[c] = acc1[c] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int at = tt * (DK / 4) + lane + L * q;
        const float4 wq = w4[at], kq = k4[at], rq = r4[at];
        const float kx[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wx[4] = {wq.x, wq.y, wq.z, wq.w};
        const float rx[4] = {rq.x, rq.y, rq.z, rq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
#pragma unroll
          for (int c = 0; c < kCpt; ++c) {
            const float kv = kx[e] * vj[c];
            const float eff = fmaf(uu[i], kv, st[c][i]);
            if (e & 1) {
              acc1[c] = fmaf(rx[e], eff, acc1[c]);
            } else {
              acc0[c] = fmaf(rx[e], eff, acc0[c]);
            }
            st[c][i] = fmaf(wx[e], st[c][i], kv);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCpt; ++c) y_part[tt][lane][slot + c * kSlots] = acc0[c] + acc1[c];
    }
    __syncthreads();                 // y_part complete, buffer `buf` consumed
    for (int e = tid; e < steps * ncols; e += NT) {
      const int tt = e / ncols;
      const int c = e - tt * ncols;
      float yj = 0.f;
#pragma unroll
      for (int l = 0; l < L; ++l) yj += y_part[tt][l][c];
      y[vbase + (t0 + tt) * vrow + c] = yj;
    }
  }
  store_state(s_fin + (static_cast<long long>(b) * H + h) * plane);
}

template <int DK>
int launch(const float* w, const float* k, const float* v, const float* r,
           const float* u, float* y, float* s_fin, float* s_bounds, int B,
           int S, int H, int dv, int chunk, int vec, cudaStream_t stream) {
  constexpr int L = lanes_for(DK);
  const long long blocks = static_cast<long long>(B) * H * ((dv + kCols - 1) / kCols);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wkv_kernel<DK, L><<<static_cast<unsigned>(blocks), L * kSlots, 0, stream>>>(
      w, k, v, r, u, y, s_fin, s_bounds, S, H, dv, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, k, r (B, S, H, dk), v (B, S, H, dv), u (H, dk): contiguous float32.
// y (B, S, H, dv), s_fin (B, H, dk, dv), s_bounds (B, S / chunk, H, dk, dv):
// contiguous float32 outputs.  dk in {8, 16, 32, 64, 128, 256} (the wrapper
// pads other head widths with zero rows), any dv >= 1, chunk divides S.  vec is 4 (16-byte copies: every input pointer 16-byte
// aligned and dv a multiple of 4) or 1.  Returns the cudaError_t of the
// launch.
extern "C" int repro_wkv_scan_f32(const float* w, const float* k,
                                  const float* v, const float* r,
                                  const float* u, float* y, float* s_fin,
                                  float* s_bounds, int B, int S, int H, int dk,
                                  int dv, int chunk, int vec, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dv < 1 || chunk < 1 ||
      S % chunk != 0 || (vec != 1 && vec != 4) || (vec == 4 && dv % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 8: return launch<8>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    case 16: return launch<16>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    case 32: return launch<32>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    case 64: return launch<64>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    case 128: return launch<128>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    case 256: return launch<256>(w, k, v, r, u, y, s_fin, s_bounds, B, S, H, dv, chunk, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
