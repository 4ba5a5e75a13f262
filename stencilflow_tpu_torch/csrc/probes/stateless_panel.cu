// P5, the stateless overlapped panel: two stages of the 7-point jacobi
// s = (c + i+ + i- + j+ + j- + k+ + k-) * c7 over an (I, J, K) float32
// array, constant-0 boundary on all six faces, in that order of adds.
//
// Replaces scripts/stateless_panel_probe.py:73 build (pallas_call :82,
// body _kernel :63, stage _stage :42), which removed the carried ring of
// the TPU's overlap kernel: each grid step took its input window (top,
// core and bottom block specs over the same array) with no ingest copy
// and computed both stages from it, so every step was independent.  On
// the H100 the port's overlap kernel (K2, backend/overlap.py) is already
// stateless; it stages the widened input tile in shared memory.  This
// kernel asks whether reading the window straight from global memory,
// with no staging copy, and walking boxes with persistent blocks moves
// its share of the bound.
//
// A block owns an output box of B planes x (TJ, TK).  Stage 1 is computed
// over the (B+2, TJ+2, TK+2) box around it, each value from seven loads
// of the (B+4, TJ+4, TK+4) input window through the read-only cache (0
// outside the array), and written to shared memory (0 where the position
// lies outside the array: the boundary condition of stage 2's reads).
// Stage 2 reads shared memory and writes the output.  Walk: grid = the
// number of boxes (one box per block), or fewer blocks (1-2 per SM,
// persistent) striding over the boxes, k fastest, then j, then i.
//
// What bounds it: 8 B per cell of device memory (0.3205 ms at 512^3 on
// the data sheet's 3.35e12 B/s) against 14 operations per cell; the halo
// is recomputed ((B+2)(TJ+2)(TK+2) / (B TJ TK) stage-1 values per output)
// and re-read through L1/L2, so the tile trades recompute for residency:
// shared memory is (B+2)(TJ+2)(TK+2) x 4 B per block.  TK is a template
// parameter (16, 32 or 64), so the position arithmetic divides by
// constants.
//
// nvcc builds sf_stateless_panel_launch; g++ (no __CUDACC__) builds
// sf_stateless_panel_host, which runs every block with one thread over
// the same per-thread bodies, its shared memory NaN-filled.
#include <cmath>
#include <vector>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_DEV __device__ __forceinline__
#define SF_HD __host__ __device__ inline
#define SF_SYNC() __syncthreads()
#define SF_LDG(p) __ldg(p)
#else
#define SF_DEV static inline
#define SF_HD static inline
#define SF_SYNC() ((void)0)
#define SF_LDG(p) (*(p))
#endif

#define SF_THREADS 256

SF_HD long long boxes_of(int I, int J, int K, int B, int TJ, int TK) {
  return (long long)((I + B - 1) / B) * ((J + TJ - 1) / TJ) *
         ((K + TK - 1) / TK);
}

// One output box of a block.
template <int TK>
SF_DEV void panel_box(const float* __restrict__ x, float* __restrict__ out,
                      float* s1, int I, int J, int K, int B, int TJ,
                      long long box, float c7, int tid, int nthr) {
  const int nbk = (K + TK - 1) / TK, nbj = (J + TJ - 1) / TJ;
  const int k0 = (int)(box % nbk) * TK;
  const int j0 = (int)((box / nbk) % nbj) * TJ;
  const int i0 = (int)(box / ((long long)nbk * nbj)) * B;
  const long long JK = (long long)J * K;
  const int W = TK + 2, H = TJ + 2;
  // stage 1 over window positions (ii, jj, kk) = global (i0 - 1 + ii, ...)
  for (int ii = 0; ii < B + 2; ++ii) {
    const int gi = i0 - 1 + ii;
    for (int r = tid; r < H * W; r += nthr) {
      const int jj = r / W, kk = r - (r / W) * W;
      const int gj = j0 - 1 + jj, gk = k0 - 1 + kk;
      float v = 0.0f;
      if (gi >= 0 && gi < I && gj >= 0 && gj < J && gk >= 0 && gk < K) {
        const float* p = x + gi * JK + (long long)gj * K + gk;
        const float c = SF_LDG(p);
        const float ip = gi + 1 < I ? SF_LDG(p + JK) : 0.0f;
        const float im = gi > 0 ? SF_LDG(p - JK) : 0.0f;
        const float jp = gj + 1 < J ? SF_LDG(p + K) : 0.0f;
        const float jm = gj > 0 ? SF_LDG(p - K) : 0.0f;
        const float kp = gk + 1 < K ? SF_LDG(p + 1) : 0.0f;
        const float km = gk > 0 ? SF_LDG(p - 1) : 0.0f;
        v = (c + ip + im + jp + jm + kp + km) * c7;
      }
      s1[(ii * H + jj) * W + kk] = v;
    }
  }
  SF_SYNC();
  // stage 2 over the box, from shared memory
  for (int ii = 0; ii < B; ++ii) {
    const int gi = i0 + ii;
    if (gi >= I) break;
    for (int r = tid; r < TJ * TK; r += nthr) {
      const int jj = r / TK, kk = r - (r / TK) * TK;
      const int gj = j0 + jj, gk = k0 + kk;
      if (gj >= J || gk >= K) continue;
      const float* q = s1 + ((ii + 1) * H + jj + 1) * W + kk + 1;
      const float v = (q[0] + q[H * W] + q[-H * W] + q[W] + q[-W] + q[1] +
                       q[-1]) * c7;
      out[gi * JK + (long long)gj * K + gk] = v;
    }
  }
  SF_SYNC();  // s1 is rewritten by the next box of a persistent block
}

#ifdef __CUDACC__
template <int TK>
__global__ void __launch_bounds__(SF_THREADS)
    sf_panel(const float* __restrict__ x, float* __restrict__ out, int I,
             int J, int K, int B, int TJ, float c7) {
  extern __shared__ float sf_smem[];
  const long long n = boxes_of(I, J, K, B, TJ, TK);
  for (long long box = blockIdx.x; box < n; box += gridDim.x)
    panel_box<TK>(x, out, sf_smem, I, J, K, B, TJ, box, c7, threadIdx.x,
                  blockDim.x);
}

static const void* pick(int tk) {
  return tk == 16 ? (const void*)sf_panel<16>
       : tk == 32 ? (const void*)sf_panel<32>
       : tk == 64 ? (const void*)sf_panel<64> : nullptr;
}

// grid 0: one block per box; else `grid` persistent blocks.
extern "C" int sf_stateless_panel_launch(const void* x, void* out, int I,
                                         int J, int K, int B, int tj, int tk,
                                         int grid, float c7, void* stream) {
  const void* fn = pick(tk);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = (B + 2) * (tj + 2) * (tk + 2) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n = boxes_of(I, J, K, B, tj, tk);
  const unsigned blocks = (unsigned)(grid > 0 && grid < n ? grid : n);
  void* args[] = {&x, &out, &I, &J, &K, &B, &tj, &c7};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(SF_THREADS), args,
                       (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Resident blocks per SM at tile (B, tj, tk); negative: a CUDA error.
extern "C" int sf_stateless_panel_occupancy(int B, int tj, int tk) {
  const void* fn = pick(tk);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  const int smem = (B + 2) * (tj + 2) * (tk + 2) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, SF_THREADS,
                                                      (size_t)smem);
  return e == cudaSuccess ? n : -(int)e;
}
#else
template <int TK>
static void host_panel(const float* x, float* out, int I, int J, int K,
                       int B, int TJ, int grid, float c7) {
  std::vector<float> s1((size_t)(B + 2) * (TJ + 2) * (TK + 2));
  const long long n = boxes_of(I, J, K, B, TJ, TK);
  const long long blocks = grid > 0 && grid < n ? grid : n;
  for (long long b = 0; b < blocks; ++b) {
    for (float& v : s1) v = NAN;
    for (long long box = b; box < n; box += blocks)
      panel_box<TK>(x, out, s1.data(), I, J, K, B, TJ, box, c7, 0, 1);
  }
}

// Returns -1 for a TK not built.
extern "C" int sf_stateless_panel_host(const void* x, void* out, int I,
                                       int J, int K, int B, int tj, int tk,
                                       int grid, float c7) {
  const float* src = (const float*)x;
  float* dst = (float*)out;
  if (tk == 16) host_panel<16>(src, dst, I, J, K, B, tj, grid, c7);
  else if (tk == 32) host_panel<32>(src, dst, I, J, K, B, tj, grid, c7);
  else if (tk == 64) host_panel<64>(src, dst, I, J, K, B, tj, grid, c7);
  else return -1;
  return 0;
}
#endif
