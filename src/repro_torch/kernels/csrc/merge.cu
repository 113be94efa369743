// Two merges of sorted (key, 32-bit payload) runs for Hopper: a merge-path
// merge of two runs (merge_sorted) and a k-way rank merge of runs laid back
// to back (merge_runs).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvmerge.py
// (_bitonic_merge_kernel / bitonic_merge) together with its wrapper's
// power-of-two padding and host-side tiling (src/repro/kernels/ops.py,
// _merge_padded / _merge_diag / merge_sorted). The JAX package folds runs
// through that merge two at a time (src/repro/serve/kvstore.py _assemble,
// src/repro/core/pushdown.py merge_row_streams); merge_runs gives the same
// result in one launch.
//
// What bounds them: bytes. Each key moves 16 bytes (key and payload read,
// key and payload written) and a merge does O(1) (merge path) or
// O(k log n) (rank) compares per output, below the card's
// operations-per-byte line. At the serving path's 900 chunk indices and
// the pushdown scan's 200,000 keys the bound is a few microseconds at
// most, so one launch costs its launch latency.
//
// merge_sorted: each 128-thread block owns 1024 consecutive outputs. Two
// threads find the block's split points in a and b by binary search on the
// merge path (the co-rank); the block stages its two slices in shared
// memory, each thread finds its own 8-output split inside them the same
// way and merges sequentially, and the merged tile leaves through
// coalesced stores. Any lengths, no sentinel and no padding, so empty runs
// and float +inf keys need no special case. Ties take a first: the merge
// is stable.
//
// merge_runs: k runs back to back, run j at [off[j], off[j+1]). Element i
// of run r, key x, lands at
//   (i - off[r]) + sum_{j<r} #{run j <= x} + sum_{j>r} #{run j < x},
// so ties go by run, then by position: the stable merge, which is what a
// fold of merge_sorted over the runs in order gives. A team of L lanes of
// one warp (L a power of two, more for more runs) owns one element: lane l
// binary-searches runs l, l + L, ... and the team sums by shuffles. No
// shared state, no sentinel: empty runs and +inf keys need no case.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int IPT = 8;           // outputs per thread
constexpr int TILE = NT * IPT;   // outputs per block

// How many of the first d merged outputs come from a (ties consume a first).
template <typename K>
__device__ __forceinline__ long long corank(const K* a, long long na, const K* b, long long nb,
                                            long long d) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - mid - 1])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename K>
__global__ void __launch_bounds__(NT)
    merge_kernel(const K* __restrict__ ak, const uint32_t* __restrict__ av, long long na,
                 const K* __restrict__ bk, const uint32_t* __restrict__ bv, long long nb,
                 K* __restrict__ ok, uint32_t* __restrict__ ov) {
  __shared__ K sk[TILE];         // a's slice, then b's slice
  __shared__ uint32_t sv[TILE];
  __shared__ K mk[TILE];         // the merged tile
  __shared__ uint32_t mv[TILE];
  __shared__ long long split[2];

  const long long total = na + nb;
  const long long d0 = (long long)blockIdx.x * TILE;
  const long long d1 = d0 + TILE < total ? d0 + TILE : total;
  if (threadIdx.x < 2) split[threadIdx.x] = corank(ak, na, bk, nb, threadIdx.x ? d1 : d0);
  __syncthreads();
  const long long i0 = split[0];
  const long long j0 = d0 - i0;
  const int la = (int)(split[1] - i0);
  const int n = (int)(d1 - d0);
  const int lb = n - la;
  for (int t = threadIdx.x; t < la; t += NT) {
    sk[t] = ak[i0 + t];
    sv[t] = av[i0 + t];
  }
  for (int t = threadIdx.x; t < lb; t += NT) {
    sk[la + t] = bk[j0 + t];
    sv[la + t] = bv[j0 + t];
  }
  __syncthreads();

  const int o0 = min((int)threadIdx.x * IPT, n);
  const int o1 = min(o0 + IPT, n);
  int i = (int)corank(sk, la, sk + la, lb, o0);
  int j = o0 - i;
  for (int o = o0; o < o1; ++o) {
    if (j >= lb || (i < la && sk[i] <= sk[la + j])) {
      mk[o] = sk[i];
      mv[o] = sv[i];
      ++i;
    } else {
      mk[o] = sk[la + j];
      mv[o] = sv[la + j];
      ++j;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += NT) {
    ok[d0 + t] = mk[t];
    ov[d0 + t] = mv[t];
  }
}

template <typename K>
int launch(const void* ak, const void* av, long long na, const void* bk, const void* bv,
           long long nb, void* ok, void* ov, cudaStream_t stream) {
  const long long blocks = (na + nb + TILE - 1) / TILE;
  merge_kernel<K><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const K*>(ak), static_cast<const uint32_t*>(av), na,
      static_cast<const K*>(bk), static_cast<const uint32_t*>(bv), nb, static_cast<K*>(ok),
      static_cast<uint32_t*>(ov));
  return (int)cudaGetLastError();
}

// Number of keys in keys[lo, hi) below x, or at most x when `inclusive`.
template <typename K>
__device__ __forceinline__ long long count_below(const K* __restrict__ keys, long long lo,
                                                 long long hi, K x, bool inclusive) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const K m = keys[mid];
    if (m < x || (inclusive && m == x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename K, int L>
__global__ void __launch_bounds__(NT)
    runs_kernel(const K* __restrict__ keys, const uint32_t* __restrict__ vals,
                const long long* __restrict__ off, int k, long long n, K* __restrict__ ok,
                uint32_t* __restrict__ ov) {
  const long long i = ((long long)blockIdx.x * NT + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  long long rank = 0;
  int r = 0;
  K x{};
  if (i < n) {
    int lo = 1, hi = k;  // r: the last run with off[r] <= i (empty runs skipped)
    while (lo <= hi) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= i)
        lo = mid + 1;
      else
        hi = mid - 1;
    }
    r = lo - 1;
    x = keys[i];
    for (int j = lane; j < k; j += L) {
      if (j == r) continue;
      const long long a = off[j];
      rank += count_below(keys, a, off[j + 1], x, j < r) - a;
    }
  }
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, s);
  if (i < n && lane == 0) {
    const long long pos = rank + i - off[r];
    ok[pos] = x;
    ov[pos] = vals[i];
  }
}

template <typename K, int L>
int launch_runs_lanes(const void* keys, const void* vals, const long long* off, int k,
                      long long n, void* ok, void* ov, cudaStream_t stream) {
  const long long blocks = (n * L + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  runs_kernel<K, L><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const K*>(keys), static_cast<const uint32_t*>(vals), off, k, n,
      static_cast<K*>(ok), static_cast<uint32_t*>(ov));
  return (int)cudaGetLastError();
}

// Lanes per element: enough that each searches at most 8 runs, up to a warp.
template <typename K>
int launch_runs(const void* keys, const void* vals, const long long* off, int k, long long n,
                void* ok, void* ov, cudaStream_t st) {
  int lanes = 1;
  while (lanes < 32 && lanes * 8 < k - 1) lanes *= 2;
  switch (lanes) {
    case 1: return launch_runs_lanes<K, 1>(keys, vals, off, k, n, ok, ov, st);
    case 2: return launch_runs_lanes<K, 2>(keys, vals, off, k, n, ok, ov, st);
    case 4: return launch_runs_lanes<K, 4>(keys, vals, off, k, n, ok, ov, st);
    case 8: return launch_runs_lanes<K, 8>(keys, vals, off, k, n, ok, ov, st);
    case 16: return launch_runs_lanes<K, 16>(keys, vals, off, k, n, ok, ov, st);
    default: return launch_runs_lanes<K, 32>(keys, vals, off, k, n, ok, ov, st);
  }
}

}  // namespace

// key_dtype: 0 = int32, 1 = uint32, 2 = float32; payloads are any 32-bit
// type, moved as raw bits. Returns a cudaError_t (0 on success); invalid
// arguments return cudaErrorInvalidValue without launching.
extern "C" int merge_sorted(const void* ak, const void* av, long long na, const void* bk,
                            const void* bv, long long nb, void* ok, void* ov, int key_dtype,
                            void* stream) {
  if (na < 0 || nb < 0 || na + nb <= 0 || (na + nb + TILE - 1) / TILE > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (key_dtype) {
    case 0: return launch<int32_t>(ak, av, na, bk, bv, nb, ok, ov, st);
    case 1: return launch<uint32_t>(ak, av, na, bk, bv, nb, ok, ov, st);
    case 2: return launch<float>(ak, av, na, bk, bv, nb, ok, ov, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// keys/vals: n keys and payloads, k >= 1 ascending runs back to back, run j
// at [off[j], off[j + 1]) with off (k + 1 int64 values on the device)
// running from 0 to n. Key dtypes as merge_sorted. Returns a cudaError_t
// (0 on success); invalid arguments return cudaErrorInvalidValue without
// launching.
extern "C" int merge_runs(const void* keys, const void* vals, const long long* off, int k,
                          long long n, void* ok, void* ov, int key_dtype, void* stream) {
  if (k < 1 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (key_dtype) {
    case 0: return launch_runs<int32_t>(keys, vals, off, k, n, ok, ov, st);
    case 1: return launch_runs<uint32_t>(keys, vals, off, k, n, ok, ov, st);
    case 2: return launch_runs<float>(keys, vals, off, k, n, ok, ov, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
