// P6 (memory/compute overlap) and P3 (cp.async plane ring) on one
// (planes, J, K) float32 array, with the plane tile, the multiply chain
// and the occupancy knob they share.
//
// P6 replaces scripts/dma_overlap_probe.py:55 build (pallas_call :56,
// body _kernel :35): does the TPU's block copy overlap vector work?  Here:
// does device-memory traffic hide behind ALU work on the H100 at the 1
// and 2 resident blocks per SM that the spilled stream kernel (K3c) and
// the panel kernel (K1) run at?  Modes:
//   dep-N    out = x multiplied N times in order by a (even op index) and
//            b (odd); N = 0 is the passthrough;
//   indep-N  out = x, and a plane accumulator acc = x[first plane of the
//            block's chunk] * 0.5 that every plane step multiplies N more
//            times with the same alternation: ALU work with no dependence
//            on the loads.  The TPU kept acc in VMEM scratch and wrote it
//            nowhere; here it lives in registers and is written to an
//            extra (chunks, J, K) output at the block's end, so nvcc
//            cannot drop the work.
// P3 replaces scripts/dma_manual_probe.py:43 build_auto (:44, body :39)
// and :95 build_manual (:96, body :57): an automatic block pipeline
// against a manual 2-slot async-copy ring.  Here `direct` is dep-N (plain
// loads into registers) and `ring` copies each block's tile of planes
// g+1 .. g+S-1 into an S-slot shared-memory ring with 16-byte
// cp.async.cg (4-byte cp.async.ca for scalar rows) before plane g is
// computed: prologue, look-ahead, wait_group, a __syncthreads before a
// slot is reused, compute from shared memory, store straight to global.
//
// What bounds them on this card: 8 B per cell of device memory (3.35e12
// B/s on the data sheet) against N multiplies per cell (33.5e12 single
// instructions/s), so bytes up to N = 80.  What limits reaching it is
// bytes in flight: a block of 256 threads keeps one 16-byte load per
// thread in flight per plane, 4 KB, so at one block per SM the card holds
// about 0.5 MB in flight where the copy floor wants several.  `dep` can
// only hide the load latency with other warps (occupancy); `indep` also
// within a warp (the acc chain does not wait for the load); `ring` with
// S-1 planes in flight per block.  The plane loop is not unrolled
// (#pragma unroll 1), so what overlaps is what the hardware and the ring
// overlap, not what nvcc hoists.
//
// Occupancy: the launch requests `smem` bytes of dynamic shared memory
// (the ring's bytes, or more to cap residency; see probes.occupancy_smem)
// and sf_dma_overlap_occupancy reports the blocks per SM it gives.
//
// Layout: a block owns a tile of TJ rows x TKU units (VEC floats each;
// VEC 4 needs K % 4 == 0, checked by the wrappers) and the planes of one
// chunk; grid (tiles, chunks).  Ragged tiles and chunks are masked.
//
// nvcc (backend/build.py's flags) builds sf_dma_overlap_launch and
// sf_async_ring_launch; g++ (no __CUDACC__) builds sf_dma_overlap_host and
// sf_async_ring_host, which run every block with one thread over the same
// per-thread bodies; the ring's copies are synchronous there, into a ring
// filled with NaN, so a wrong slot shows.
#include <cmath>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_DEV __device__ __forceinline__
#define SF_HD __host__ __device__ inline
#define SF_SYNC() __syncthreads()
#else
#define SF_DEV static inline
#define SF_HD static inline
#define SF_SYNC() ((void)0)
#endif

#define SF_TJ 8
#define SF_TKU 32
#define SF_THREADS (SF_TJ * SF_TKU)

// Block `bx`'s tile: its first row and first unit column (one division
// per block, outside every loop).
struct Tile {
  int j0, ku0;
};

template <int VEC>
SF_DEV Tile block_tile(long long bx, int K) {
  const int tiles_k = ((K + VEC - 1) / VEC + SF_TKU - 1) / SF_TKU;
  Tile t;
  t.j0 = (int)(bx / tiles_k) * SF_TJ;
  t.ku0 = (int)(bx % tiles_k) * SF_TKU;
  return t;
}

// The unit `u` of a tile: global row j and first column k, and whether
// it lies in the array (shifts and masks only: it runs per plane).
struct Unit {
  int j, k;
  bool valid;
};

template <int VEC>
SF_DEV Unit tile_unit(const Tile& t, int u, int J, int K) {
  Unit r;
  r.j = t.j0 + u / SF_TKU;
  r.k = (t.ku0 + u % SF_TKU) * VEC;
  r.valid = r.j < J && r.k < K;
  return r;
}

template <int VEC>
SF_DEV void load_unit(const float* p, float* v) {
  if (VEC == 4) {
#ifdef __CUDACC__
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
    std::memcpy(v, p, 16);
#endif
  } else {
    v[0] = *p;
  }
}

template <int VEC>
SF_DEV void store_unit(float* p, const float* v) {
  if (VEC == 4) {
#ifdef __CUDACC__
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
    std::memcpy(p, v, 16);
#endif
  } else {
    *p = v[0];
  }
}

// N dependent multiplies on each of the VEC values: a at even op index,
// b at odd.
template <int VEC>
SF_DEV void chain(float* v, int nops, float a, float b) {
  int i = 0;
#pragma unroll 4
  for (; i + 1 < nops; i += 2) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = v[e] * a;
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = v[e] * b;
  }
  if (i < nops) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = v[e] * a;
  }
}

// P6, one block: mode 0 dep, 1 indep (acc is (chunks, J, K)).
template <int VEC, int MODE>
SF_DEV void overlap_block(const float* __restrict__ x, float* __restrict__ out,
                          float* __restrict__ acc, int P, int J, int K,
                          int chunk, int nops, float a, float b, long long bx,
                          long long by, int tid, int nthr) {
  const long long p0 = by * chunk;
  const long long p1 = (p0 + chunk < P) ? p0 + chunk : P;
  const long long JK = (long long)J * K;
  const Tile tile = block_tile<VEC>(bx, K);
  for (int u = tid; u < SF_THREADS; u += nthr) {
    const Unit t = tile_unit<VEC>(tile, u, J, K);
    if (!t.valid) continue;
    const long long off = (long long)t.j * K + t.k;
    float v[VEC], s[VEC];
    if (MODE == 1) {
      load_unit<VEC>(x + p0 * JK + off, s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = s[e] * 0.5f;
    }
#pragma unroll 1
    for (long long p = p0; p < p1; ++p) {
      load_unit<VEC>(x + p * JK + off, v);
      if (MODE == 0)
        chain<VEC>(v, nops, a, b);
      else
        chain<VEC>(s, nops, a, b);
      store_unit<VEC>(out + p * JK + off, v);
    }
    if (MODE == 1) store_unit<VEC>(acc + by * JK + off, s);
  }
}

#ifdef __CUDACC__
template <int VEC>
SF_DEV void ring_copy(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}
SF_DEV void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
SF_DEV void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#else
template <int VEC>
SF_DEV void ring_copy(float* dst, const float* src) {
  std::memcpy(dst, src, 4 * VEC);
}
SF_DEV void ring_commit() {}
template <int N>
SF_DEV void ring_wait() {}
#endif

// P3's ring, one block: the tile of plane p goes to slot (p - p0) % S.
template <int VEC, int S>
SF_DEV void ring_issue(const float* __restrict__ x, float* ring, long long p,
                       int slot, int J, int K, const Tile& tile, int tid,
                       int nthr) {
  const long long JK = (long long)J * K;
  for (int u = tid; u < SF_THREADS; u += nthr) {
    const Unit t = tile_unit<VEC>(tile, u, J, K);
    if (t.valid)
      ring_copy<VEC>(ring + (slot * SF_THREADS + u) * VEC,
                     x + p * JK + (long long)t.j * K + t.k);
  }
}

template <int VEC, int S>
SF_DEV void ring_block(const float* __restrict__ x, float* __restrict__ out,
                       float* ring, int P, int J, int K, int chunk, int nops,
                       float a, float b, long long bx, long long by, int tid,
                       int nthr) {
  const long long p0 = by * chunk;
  const long long p1 = (p0 + chunk < P) ? p0 + chunk : P;
  const long long JK = (long long)J * K;
  const Tile tile = block_tile<VEC>(bx, K);
  // prologue: planes p0 .. p0 + S - 2 in flight, one commit group each
  for (int s = 0; s < S - 1; ++s) {
    if (p0 + s < p1) ring_issue<VEC, S>(x, ring, p0 + s, s, J, K, tile, tid,
                                        nthr);
    ring_commit();
  }
#pragma unroll 1
  for (long long p = p0; p < p1; ++p) {
    const int g = (int)(p - p0);
    ring_wait<S - 2>();  // plane p's group (S - 2 younger ones may fly)
    SF_SYNC();           // plane p visible; every thread done with p - 1
    // look-ahead into the slot plane p - 1 held
    if (p + S - 1 < p1)
      ring_issue<VEC, S>(x, ring, p + S - 1, (g + S - 1) % S, J, K, tile,
                         tid, nthr);
    ring_commit();
    for (int u = tid; u < SF_THREADS; u += nthr) {
      const Unit t = tile_unit<VEC>(tile, u, J, K);
      if (!t.valid) continue;
      float v[VEC];
      load_unit<VEC>(ring + ((g % S) * SF_THREADS + u) * VEC, v);
      chain<VEC>(v, nops, a, b);
      store_unit<VEC>(out + p * JK + (long long)t.j * K + t.k, v);
    }
  }
  ring_wait<0>();
}

SF_HD long long grid_tiles(int J, int K, int vec) {
  const long long ku = ((long long)K + vec - 1) / vec;
  return ((long long)J + SF_TJ - 1) / SF_TJ * ((ku + SF_TKU - 1) / SF_TKU);
}

#ifdef __CUDACC__
template <int VEC, int MODE>
__global__ void __launch_bounds__(SF_THREADS)
    sf_overlap(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ acc, int P, int J, int K, int chunk,
               int nops, float a, float b) {
  overlap_block<VEC, MODE>(x, out, acc, P, J, K, chunk, nops, a, b,
                           blockIdx.x, blockIdx.y, threadIdx.x, blockDim.x);
}

template <int VEC, int S>
__global__ void __launch_bounds__(SF_THREADS)
    sf_ring(const float* __restrict__ x, float* __restrict__ out, int P,
            int J, int K, int chunk, int nops, float a, float b) {
  extern __shared__ __align__(16) float sf_smem[];
  ring_block<VEC, S>(x, out, sf_smem, P, J, K, chunk, nops, a, b,
                     blockIdx.x, blockIdx.y, threadIdx.x, blockDim.x);
}

// The kernel of (kind, vec, slots): kind 0 dep, 1 indep, 2 ring.
static const void* pick(int kind, int vec, int slots) {
  if (kind == 0) return vec == 4 ? (const void*)sf_overlap<4, 0>
                                 : (const void*)sf_overlap<1, 0>;
  if (kind == 1) return vec == 4 ? (const void*)sf_overlap<4, 1>
                                 : (const void*)sf_overlap<1, 1>;
  if (vec == 4)
    return slots == 2 ? (const void*)sf_ring<4, 2>
         : slots == 3 ? (const void*)sf_ring<4, 3>
         : slots == 4 ? (const void*)sf_ring<4, 4> : nullptr;
  return slots == 2 ? (const void*)sf_ring<1, 2>
       : slots == 3 ? (const void*)sf_ring<1, 3>
       : slots == 4 ? (const void*)sf_ring<1, 4> : nullptr;
}

static int launch(int kind, int vec, int slots, int smem, void** args,
                  int P, int J, int K, int chunk, void* stream) {
  const void* fn = pick(kind, vec, slots);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)grid_tiles(J, K, vec),
                  (unsigned)((P + chunk - 1) / chunk));
  e = cudaLaunchKernel(fn, grid, dim3(SF_THREADS), args, (size_t)smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// P6: mode 0 dep, 1 indep; acc (chunks, J, K) is written by indep only.
extern "C" int sf_dma_overlap_launch(const void* x, void* out, void* acc,
                                     int P, int J, int K, int chunk,
                                     int mode, int vec, int nops, float a,
                                     float b, int smem, void* stream) {
  void* args[] = {&x, &out, &acc, &P, &J, &K, &chunk, &nops, &a, &b};
  return launch(mode, vec, 0, smem, args, P, J, K, chunk, stream);
}

// P3: mode 0 direct (P6's dep kernel), 1 the S-slot ring.
extern "C" int sf_async_ring_launch(const void* x, void* out, int P, int J,
                                    int K, int chunk, int mode, int slots,
                                    int vec, int nops, float a, float b,
                                    int smem, void* stream) {
  if (mode == 0) {
    void* acc = nullptr;
    void* args[] = {&x, &out, &acc, &P, &J, &K, &chunk, &nops, &a, &b};
    return launch(0, vec, 0, smem, args, P, J, K, chunk, stream);
  }
  void* args[] = {&x, &out, &P, &J, &K, &chunk, &nops, &a, &b};
  return launch(2, vec, slots, smem, args, P, J, K, chunk, stream);
}

// Resident blocks per SM of kernel (kind, vec, slots) with `smem` bytes
// of dynamic shared memory; negative: a CUDA error.
extern "C" int sf_dma_overlap_occupancy(int kind, int vec, int slots,
                                        int smem) {
  const void* fn = pick(kind, vec, slots);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, SF_THREADS,
                                                      (size_t)smem);
  return e == cudaSuccess ? n : -(int)e;
}
#else
extern "C" void sf_dma_overlap_host(const void* x, void* out, void* acc,
                                    int P, int J, int K, int chunk, int mode,
                                    int vec, int nops, float a, float b) {
  const float* src = (const float*)x;
  float* dst = (float*)out;
  float* ac = (float*)acc;
  const long long tiles = grid_tiles(J, K, vec);
  for (long long by = 0; by < (P + chunk - 1) / chunk; ++by)
    for (long long bx = 0; bx < tiles; ++bx) {
      if (vec == 4 && mode == 0)
        overlap_block<4, 0>(src, dst, ac, P, J, K, chunk, nops, a, b, bx, by,
                            0, 1);
      else if (vec == 4)
        overlap_block<4, 1>(src, dst, ac, P, J, K, chunk, nops, a, b, bx, by,
                            0, 1);
      else if (mode == 0)
        overlap_block<1, 0>(src, dst, ac, P, J, K, chunk, nops, a, b, bx, by,
                            0, 1);
      else
        overlap_block<1, 1>(src, dst, ac, P, J, K, chunk, nops, a, b, bx, by,
                            0, 1);
    }
}

template <int VEC, int S>
static void ring_host(const float* x, float* out, int P, int J, int K,
                      int chunk, int nops, float a, float b) {
  float ring[S * SF_THREADS * VEC];
  const long long tiles = grid_tiles(J, K, VEC);
  for (long long by = 0; by < (P + chunk - 1) / chunk; ++by)
    for (long long bx = 0; bx < tiles; ++bx) {
      for (float& r : ring) r = NAN;
      ring_block<VEC, S>(x, out, ring, P, J, K, chunk, nops, a, b, bx, by, 0,
                         1);
    }
}

// mode 0 direct (dep), 1 ring; returns -1 for a slot count not built.
extern "C" int sf_async_ring_host(const void* x, void* out, int P, int J,
                                  int K, int chunk, int mode, int slots,
                                  int vec, int nops, float a, float b) {
  const float* src = (const float*)x;
  float* dst = (float*)out;
  if (mode == 0) {
    sf_dma_overlap_host(x, out, nullptr, P, J, K, chunk, 0, vec, nops, a, b);
    return 0;
  }
#define SF_RING(V, S_)                                          \
  if (vec == V && slots == S_) {                                \
    ring_host<V, S_>(src, dst, P, J, K, chunk, nops, a, b);     \
    return 0;                                                   \
  }
  SF_RING(4, 2) SF_RING(4, 3) SF_RING(4, 4)
  SF_RING(1, 2) SF_RING(1, 3) SF_RING(1, 4)
#undef SF_RING
  return -1;
}
#endif
