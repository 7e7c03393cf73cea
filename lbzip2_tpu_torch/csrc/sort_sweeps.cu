// Compare-exchange sweeps over row blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/tpu_sort_probe.py::pallas_sweeps
// (body _sweep_kernel): the speed-of-light probe of a sort network.
// keys (B, R, 128) int32 are cut into `sub` blocks of M = R / sub rows.
// Inside a block every lane is an independent cyclic column of M
// values, and one sweep is
//
//   kn[r] = k[(r - 1) mod M];   k = min(k, kn) ^ (max(k, kn) & 1)
//
// repeated `sweeps` times.  (The TPU kernel rolls the block's leading
// axis, which its (1, M, 128) block spec makes the size-1 batch axis,
// so there each value meets itself; this kernel computes the sweep the
// probe describes, with the neighbour one row up.)
//
// What bounds it: the integer pipe.  A (32, 7040, 128) batch is 28.8 M
// values, and 210 sweeps are 6.06 G compare-exchanges against one read
// and one write of device memory (230 MB).  The function needs a min, a
// max, an and and a xor each; Hopper's SM issues 64 integer min/max or
// logic results a clock, half its FP32 rate, and min, max and the fused
// and-xor (LOP3) all go there.  So the design:
//
//   - takes the max off that pipe: max = a + b - min, exact in wrapping
//     int32, as two IMADs on the FMA pipe, by 1 and by -1 passed in as
//     arguments so that ptxas cannot fold them back into an IADD3.  Two
//     of the four instructions of a compare-exchange stay on the ALU;
//   - keeps each column in the registers of a run of lanes of one warp:
//     lane i of a column's n lanes holds rows [i * PER, (i + 1) * PER),
//     PER a template constant, and takes its neighbour row from lane
//     i - 1 (lane n - 1 for lane 0: the wrap at the block edge) with one
//     shuffle a sweep, so no sweep waits at a barrier.  Each lane updates
//     its rows from the last to the first: PER independent
//     compare-exchanges a sweep.  A column that no 32 lanes divide spans
//     2 to 8 warps of a CTA of 8 (up to 256 lanes of 64 rows or fewer),
//     or 16 or 32 warps of a CTA of 32 (up to 1024 lanes of 32 rows or
//     fewer, the 64 registers a thread has there), which pass their edge
//     rows through shared memory behind one barrier a sweep;
//   - stages the CTA's tile of M rows by C columns (C * 4 bytes a row)
//     through shared memory, so the one read and the one write of device
//     memory are coalesced while the lanes own columns (C = 1 or 2 in
//     the widest columns: a fallback, not a fast path).
//
// PER takes the powers of two up to 64, which divide every block the
// kernel takes, and 55, which lays the probe's blocks of 1760 rows into
// one warp a column (32 x 55): 8 instances in CTAs of 8 warps, 6 in
// CTAs of 32.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); the launch plan (PER, n, warps a
// column, C, warps a CTA) comes from the caller
// (lbzip2_tpu_torch/ops/sort_sweeps.py::plan).  Launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr unsigned kFull = 0xffffffffu;

// min(a, b) ^ (max(a, b) & 1), with max = a + b - min on the FMA pipe
// (one == 1, neg == -1)
__device__ __forceinline__ int cex(int a, int b, int one, int neg) {
  const int lo = min(a, b);
  const int hi = lo * neg + (a * one + b);
  return lo ^ (hi & 1);
}

// CTAs of 8 warps: three an SM while PER values and their addressing fit
// 85 registers, else two (at the probe's PER = 55 two CTAs an SM, with
// the 123 registers ptxas takes when allowed, ran slower).  CTAs of 32
// warps: one an SM, 64 registers a thread.
template <int PER, int WARPS>
__global__ void __launch_bounds__(WARPS * 32,
                                  WARPS == 8 ? (PER <= 56 ? 3 : 2) : 1)
    sweep_kernel(const int* __restrict__ in, int* __restrict__ out, int R,
                 int M, int n, int wpc, int log_c, int sweeps, int one,
                 int neg) {
  extern __shared__ int tile[];  // M rows x C columns
  __shared__ int edge[2][WARPS];
  const int C = 1 << log_c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base =
      ((size_t)blockIdx.z * R + (size_t)blockIdx.y * M) * kLanes +
      (size_t)blockIdx.x * C;

  // this lane's column, position in it and neighbour lane; with a column
  // of several warps, the warp whose last active lane feeds this warp's
  // lane 0 and the lane whose row the next warp takes
  int col, pos, src, prev_warp = 0, last = 31;
  bool active;
  if (wpc == 1) {  // a column is n <= 32 lanes, C / WARPS columns a warp
    const int seg = lane / n;
    pos = lane - seg * n;
    col = warp * (C / WARPS) + seg;
    active = seg < C / WARPS;
    src = active ? seg * n + (pos == 0 ? n - 1 : pos - 1) : lane;
  } else {  // a column is the first n lanes of wpc warps
    const int wi = warp % wpc;
    col = warp / wpc;
    pos = wi * 32 + lane;
    active = pos < n;
    src = (lane + 31) & 31;
    prev_warp = col * wpc + (wi == 0 ? (n - 1) >> 5 : wi - 1);
    last = min(31, n - 1 - wi * 32);
  }

  for (int e = threadIdx.x; e < M << log_c; e += blockDim.x)
    tile[e] = in[base + (size_t)(e >> log_c) * kLanes + (e & (C - 1))];
  __syncthreads();
  int v[PER];
  if (active) {
#pragma unroll
    for (int j = 0; j < PER; ++j) v[j] = tile[(pos * PER + j) * C + col];
  }

#pragma unroll 1  // PER independent updates a sweep are ILP enough
  for (int s = 0; s < sweeps; ++s) {
    int nb = __shfl_sync(kFull, v[PER - 1], src);
    if (wpc > 1) {  // lane 0 of each warp: the edge row of the warp before
      if (lane == last) edge[s & 1][warp] = v[PER - 1];
      __syncthreads();
      if (lane == 0) nb = edge[s & 1][prev_warp];
    }
#pragma unroll
    for (int j = PER - 1; j > 0; --j) v[j] = cex(v[j], v[j - 1], one, neg);
    v[0] = cex(v[0], nb, one, neg);
  }

  if (active) {  // the rows this lane read: no other lane touches them
#pragma unroll
    for (int j = 0; j < PER; ++j) tile[(pos * PER + j) * C + col] = v[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M << log_c; e += blockDim.x)
    out[base + (size_t)(e >> log_c) * kLanes + (e & (C - 1))] = tile[e];
}

template <int PER, int WARPS>
int launch(const int* in, int* out, int B, int R, int sub, int n, int wpc,
           int C, int sweeps, cudaStream_t s) {
  const int M = R / sub;
  int log_c = 0;
  while ((1 << log_c) < C) ++log_c;
  const size_t smem = (size_t)M * C * sizeof(int);
  if (M * sub != R || (1 << log_c) != C || kLanes % C != 0 ||
      n * PER != M ||
      (wpc == 1 ? C % WARPS != 0 || n * (C / WARPS) > 32
                : n > 32 * wpc || WARPS % wpc != 0 || C * wpc != WARPS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<PER, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<PER, WARPS><<<dim3(kLanes / C, sub, B), WARPS * 32, smem, s>>>(
      in, out, R, M, n, wpc, log_c, sweeps, 1, -1);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const int*, int*, int, int, int, int, int, int, int,
                       cudaStream_t);

Launch pick(int per, int warps) {
  if (warps == 8) {
    switch (per) {
      case 1: return launch<1, 8>;
      case 2: return launch<2, 8>;
      case 4: return launch<4, 8>;
      case 8: return launch<8, 8>;
      case 16: return launch<16, 8>;
      case 32: return launch<32, 8>;
      case 55: return launch<55, 8>;
      case 64: return launch<64, 8>;
    }
  } else if (warps == 32) {
    switch (per) {
      case 1: return launch<1, 32>;
      case 2: return launch<2, 32>;
      case 4: return launch<4, 32>;
      case 8: return launch<8, 32>;
      case 16: return launch<16, 32>;
      case 32: return launch<32, 32>;
    }
  }
  return nullptr;
}

}  // namespace

// keys / out (B, R, 128) int32 device pointers; R / sub rows a block,
// laid out as `plan` says: per rows a lane, n lanes a column (the first
// n lanes of wpc warps when wpc > 1), C columns a CTA of `warps` warps.
extern "C" int lbz2t_sort_sweeps(const void* keys, void* out, int B, int R,
                                 int sub, int per, int n, int wpc, int C,
                                 int warps, int sweeps, void* stream) {
  if (B <= 0 || R <= 0) return (int)cudaGetLastError();
  const Launch fn = pick(per, warps);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(static_cast<const int*>(keys), static_cast<int*>(out), B, R, sub,
            n, wpc, C, sweeps, static_cast<cudaStream_t>(stream));
}
