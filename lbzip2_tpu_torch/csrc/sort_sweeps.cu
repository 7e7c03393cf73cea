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
// What bounds it on the card: integer throughput.  A (32, 7040, 128)
// batch is 28.8 M values and each sweep costs two min/max and one
// and-xor per value; device memory is read and written once in all
// (230 MB), against 210 sweeps of compute.  A (1760, 128) block is
// 901 KB, more than a block's 227 KB of shared memory, so the design
// keeps the values in registers:
//
//   - one CTA owns C lanes of one block; thread (c, t) holds rows
//     [t * PER, t * PER + PER) of lane c in registers, PER a template
//     constant so the array never leaves registers; T = M / PER
//     threads cover the column exactly;
//   - a warp's load or store at register j touches C consecutive lanes
//     of one row (C = 16 at the probe shape: two 64-byte runs), so the
//     one read and the one write are coalesced without staging;
//   - per sweep each thread publishes its last row to shared memory
//     (double-buffered by sweep parity, so one __syncthreads a sweep),
//     takes its predecessor's (thread T-1's for thread 0: the wrap at
//     the block edge), and updates its rows from the last to the first,
//     so every update reads the old value below it: PER independent
//     compare-exchanges per thread and sweep.
//
// Plain C interface, built with nvcc -shared and loaded with ctypes
// (lbzip2_tpu_torch/_build.py); the launch plan (PER, T, C) comes from
// the caller (lbzip2_tpu_torch/ops/sort_sweeps.py::plan).  Launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int cex(int a, int b) {
  return min(a, b) ^ (max(a, b) & 1);
}

// Registers per thread: PER values plus addressing; 64 values need the
// 128-register budget of a 512-thread CTA.
template <int PER>
constexpr int max_threads() {
  return PER <= 32 ? kMaxThreads : kMaxThreads / 2;
}

template <int PER>
__global__ void __launch_bounds__(PER <= 32 ? kMaxThreads : kMaxThreads / 2)
    sweep_kernel(const int* __restrict__ in, int* __restrict__ out, int R,
                 int M, int sweeps) {
  __shared__ int xch[2 * kMaxThreads];
  const int C = blockDim.x, T = blockDim.y;
  const int c = threadIdx.x, t = threadIdx.y;
  const size_t base =
      ((size_t)blockIdx.z * R + (size_t)blockIdx.y * M + (size_t)t * PER) *
          kLanes +
      (size_t)blockIdx.x * C + c;

  int v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = in[base + (size_t)j * kLanes];

  const int dst = t * C + c;
  const int src = (t == 0 ? T - 1 : t - 1) * C + c;
  for (int s = 0; s < sweeps; ++s) {
    int* buf = xch + (s & 1) * kMaxThreads;
    buf[dst] = v[PER - 1];
    __syncthreads();
    const int nb = buf[src];
#pragma unroll
    for (int j = PER - 1; j > 0; --j) v[j] = cex(v[j], v[j - 1]);
    v[0] = cex(v[0], nb);
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) out[base + (size_t)j * kLanes] = v[j];
}

template <int PER>
int launch(const int* in, int* out, int B, int R, int sub, int T, int C,
           int sweeps, cudaStream_t s) {
  if (T * C > max_threads<PER>() || T * PER * sub != R || kLanes % C != 0)
    return (int)cudaErrorInvalidValue;
  sweep_kernel<PER><<<dim3(kLanes / C, sub, B), dim3(C, T), 0, s>>>(
      in, out, R, R / sub, sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// keys / out (B, R, 128) int32 device pointers; R = sub * T * per.
extern "C" int lbz2t_sort_sweeps(const void* keys, void* out, int B, int R,
                                 int sub, int per, int T, int C, int sweeps,
                                 void* stream) {
  if (B <= 0 || R <= 0) return (int)cudaGetLastError();
  const int* in = static_cast<const int*>(keys);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: return launch<1>(in, o, B, R, sub, T, C, sweeps, s);
    case 2: return launch<2>(in, o, B, R, sub, T, C, sweeps, s);
    case 4: return launch<4>(in, o, B, R, sub, T, C, sweeps, s);
    case 8: return launch<8>(in, o, B, R, sub, T, C, sweeps, s);
    case 16: return launch<16>(in, o, B, R, sub, T, C, sweeps, s);
    case 32: return launch<32>(in, o, B, R, sub, T, C, sweeps, s);
    case 64: return launch<64>(in, o, B, R, sub, T, C, sweeps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
