// P4, the copy floor: out = in over a (planes, J, K) float32 array.
//
// Replaces scripts/dma_matrix_probe.py:29 build (pallas_call :36), the
// TPU's passthrough block copy swept over block size, grid semantics,
// VMEM limit and plane shape.  On the H100 a copy is bound by device
// memory bytes: each element is read once and written once, 8 B per cell
// at 3.35e12 B/s on the data sheet.  The sweep varies what the card's
// copy rate depends on instead of the TPU's block factors: bytes per
// thread per access (4 B scalar against 16 B float4), threads per block,
// blocks per SM (a grid-stride loop over the flat array with a fixed
// number of resident blocks) against one (plane, row tile) per block,
// the row width (512 against 256 floats at equal bytes), and a size
// beyond the 50 MB L2 against one that fits.  The best sustained rate
// beyond L2 is the port's copy floor (config.H100_COPY_FLOOR).
//
// Ragged edges are masked here: the flat loop ends with a scalar tail,
// and a tile masks the rows past J and the units past K, so any shape is
// legal (float4 tiles need K % 4 == 0, checked by the wrapper).
//
// nvcc (backend/build.py's flags) builds sf_copy_launch; g++ (no
// __CUDACC__) builds sf_copy_host, which runs every block with one thread
// over the same per-thread bodies.
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_DEV __device__ __forceinline__
#else
#define SF_DEV static inline
struct float4 { float x, y, z, w; };
#endif

// Flat mode: thread `t` of `nthreads` walks the array in VEC-float units
// (grid stride); the last n % VEC floats are copied one by one.
template <int VEC>
SF_DEV void copy_flat(const float* __restrict__ in, float* __restrict__ out,
                      long long n, long long t, long long nthreads) {
  if (VEC == 4) {
    const long long nv = n / 4;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long v = t; v < nv; v += nthreads) out4[v] = in4[v];
    for (long long e = nv * 4 + t; e < n; e += nthreads) out[e] = in[e];
  } else {
    for (long long e = t; e < n; e += nthreads) out[e] = in[e];
  }
}

// Tile mode: block (bx, by) copies rows [bx * rows, bx * rows + rows) of
// plane by, masked to J; thread `tid` of `nthr` strides over the tile's
// VEC-float units (VEC 4: K % 4 == 0, so every row starts 16-B aligned).
template <int VEC>
SF_DEV void copy_tile(const float* __restrict__ in, float* __restrict__ out,
                      int J, int K, int rows, long long bx, long long by,
                      int tid, int nthr) {
  const long long j0 = bx * rows;
  const long long nrows = (J - j0 < rows) ? (J - j0) : rows;
  if (nrows <= 0) return;
  const long long base = (by * J + j0) * K;
  const long long units = nrows * K / VEC;
  if (VEC == 4) {
    const float4* in4 = reinterpret_cast<const float4*>(in + base);
    float4* out4 = reinterpret_cast<float4*>(out + base);
    for (long long v = tid; v < units; v += nthr) out4[v] = in4[v];
  } else {
    for (long long e = tid; e < units; e += nthr)
      out[base + e] = in[base + e];
  }
}

#ifdef __CUDACC__
template <int VEC>
__global__ void sf_copy_flat(const float* __restrict__ in,
                             float* __restrict__ out, long long n) {
  copy_flat<VEC>(in, out, n, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                 (long long)gridDim.x * blockDim.x);
}

template <int VEC>
__global__ void sf_copy_tile(const float* __restrict__ in,
                             float* __restrict__ out, int J, int K,
                             int rows) {
  copy_tile<VEC>(in, out, J, K, rows, blockIdx.x, blockIdx.y, threadIdx.x,
                 blockDim.x);
}

// mode 0: flat, `grid` blocks of `threads` (grid stride); mode 1: tiles
// of `grid` rows, one per block.  Returns cudaGetLastError().
extern "C" int sf_copy_launch(const void* in, void* out, int planes, int J,
                              int K, int mode, int vec, int threads,
                              int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* src = (const float*)in;
  float* dst = (float*)out;
  if (mode == 0) {
    const long long n = (long long)planes * J * K;
    if (vec == 4)
      sf_copy_flat<4><<<grid, threads, 0, s>>>(src, dst, n);
    else
      sf_copy_flat<1><<<grid, threads, 0, s>>>(src, dst, n);
  } else {
    const dim3 blocks((J + grid - 1) / grid, planes);
    if (vec == 4)
      sf_copy_tile<4><<<blocks, threads, 0, s>>>(src, dst, J, K, grid);
    else
      sf_copy_tile<1><<<blocks, threads, 0, s>>>(src, dst, J, K, grid);
  }
  return (int)cudaGetLastError();
}
#else
extern "C" void sf_copy_host(const void* in, void* out, int planes, int J,
                             int K, int mode, int vec, int threads,
                             int grid) {
  const float* src = (const float*)in;
  float* dst = (float*)out;
  if (mode == 0) {
    const long long n = (long long)planes * J * K;
    const long long nthreads = (long long)grid * threads;
    for (long long t = 0; t < nthreads; ++t) {
      if (vec == 4)
        copy_flat<4>(src, dst, n, t, nthreads);
      else
        copy_flat<1>(src, dst, n, t, nthreads);
    }
  } else {
    for (long long by = 0; by < planes; ++by)
      for (long long bx = 0; bx < (J + grid - 1) / grid; ++bx) {
        if (vec == 4)
          copy_tile<4>(src, dst, J, K, grid, bx, by, 0, 1);
        else
          copy_tile<1>(src, dst, J, K, grid, bx, by, 0, 1);
      }
  }
}
#endif
