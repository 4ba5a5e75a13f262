// P2, weights from a small table at a runtime row: out[g] = sum over d of
// tab[row(g), d] * (x + d), for steps g of a (ROWS, COLS) plane x.
//
// Replaces scripts/smem_table_probe.py:38 build (pallas_call :39, body
// kernel :23), which checked that Mosaic reads an SMEM table at a traced
// row and broadcasts the scalar over a VMEM plane.  The row is clamped
// as the composed i-table's is: D = NTAB / 2, row(g) = g < D ? g :
// (g >= steps - D ? NTAB + g - steps : D).  Each step computes
// acc = 0; acc = acc + tab[row, d] * (x + d) for d = 0 .. NOFF-1, in that
// order, and writes rows [g * ROWS, (g + 1) * ROWS) of the output.
//
// On the H100 it asks what the stream kernel's composed stage (K3b) pays
// for its i-table, read today with one __ldg per term at a runtime row
// inside the per-cell loop (backend/codegen.py, `banded`).  Variants:
//   0 ldg    one __ldg per term at the runtime row (what K3b emits);
//   1 const  __constant__ memory, copied in before the launch; the row is
//            uniform over the block at each step, so reads broadcast;
//   2 smem   the table staged to shared memory once per block;
//   3 param  the row's NOFF weights passed by value as a launch parameter
//            (the immediates of a kernel specialised per row): one launch
//            per run of steps with equal rows, so the interior steps and
//            one per boundary row.
// What bounds it: the 4 B written per output cell.  The function needs
// NOFF adds per input cell (x + d does not depend on the step) and 2 NOFF
// operations per cell of each distinct row (NTAB rows at most: the other
// steps repeat row D), 0.0043 ms of operations against 0.0201 ms of
// bytes at 256 steps of 256 x 256 with a 33 x 33 table.  The kernel does
// 3 NOFF operations per output cell (it recomputes x + d and each step's
// sum, repeated rows too), so what it measures is the per-step table
// read.  The design keeps x in a register per step
// (re-read each step: x is not __restrict__, so nvcc may not hoist x + d
// out of the step loop) and NOFF a template parameter, so the term loop
// is unrolled and a param weight is a constant-bank operand.
//
// Layout: x is flat (n = ROWS * COLS cells) in units of VEC floats (VEC 4
// needs n % 4 == 0); a block owns SF_THREADS units and a chunk of steps;
// grid (unit tiles, step chunks).  Ragged tiles and chunks are masked.
//
// nvcc builds sf_table_read_launch; g++ (no __CUDACC__) builds
// sf_table_read_host, which runs every block with one thread over the
// same per-thread bodies (shared memory NaN-filled before staging).
#include <cmath>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_DEV __device__ __forceinline__
#define SF_HD __host__ __device__ inline
#define SF_SYNC() __syncthreads()
#define SF_LDG(p) __ldg(p)
#define SF_CONST __constant__
#else
#define SF_DEV static inline
#define SF_HD static inline
#define SF_SYNC() ((void)0)
#define SF_LDG(p) (*(p))
#define SF_CONST static
#endif

#define SF_THREADS 256
#define SF_CONST_FLOATS 16384  // the 64 KB constant bank
#define SF_MAX_NOFF 64
#define SF_MAX_NTAB 128
#define SF_MAX_RUNS (SF_MAX_NTAB + 1)
// the term counts built (each a template instance)
#define SF_NOFFS(X) X(3) X(5) X(33)

SF_CONST float sf_ctab[SF_CONST_FLOATS];

struct Row {
  float w[SF_MAX_NOFF];
};

SF_HD int table_row(int g, int steps, int ntab) {
  const int D = ntab / 2;
  return g < D ? g : (g >= steps - D ? ntab + g - steps : D);
}

template <int VEC>
SF_DEV void load_unit(const float* p, float* v) {
#ifdef __CUDACC__
  if (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#endif
  for (int e = 0; e < VEC; ++e) v[e] = p[e];
}

template <int VEC>
SF_DEV void store_unit(float* p, const float* v) {
#ifdef __CUDACC__
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#endif
  for (int e = 0; e < VEC; ++e) p[e] = v[e];
}

// One block: units [bx * SF_THREADS, ...) of x, steps [g0, g1).  VAR 3
// takes its weights from `prm` (one row per launch); the others read row
// table_row(g) of their copy of the table.
template <int VEC, int NOFF, int VAR>
SF_DEV void table_block(const float* x, float* out, const float* tab,
                        const Row& prm, float* stab, long long n, int steps,
                        int ntab, int g0, int g1, long long bx, int tid,
                        int nthr) {
  if (VAR == 2) {
    for (int e = tid; e < ntab * NOFF; e += nthr) stab[e] = tab[e];
    SF_SYNC();
  }
  for (int u = tid; u < SF_THREADS; u += nthr) {
    const long long c = (bx * SF_THREADS + u) * VEC;
    if (c >= n) continue;
#pragma unroll 1
    for (int g = g0; g < g1; ++g) {
      float xv[VEC], acc[VEC];
      load_unit<VEC>(x + c, xv);
      const int row = table_row(g, steps, ntab);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int d = 0; d < NOFF; ++d) {
        float w;
        if (VAR == 0)
          w = SF_LDG(tab + row * NOFF + d);
        else if (VAR == 1)
          w = sf_ctab[row * NOFF + d];
        else if (VAR == 2)
          w = stab[row * NOFF + d];
        else
          w = prm.w[d];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = acc[e] + w * (xv[e] + (float)d);
      }
      store_unit<VEC>(out + (long long)g * n + c, acc);
    }
  }
}

// The runs of steps with equal rows: at most 2 * (NTAB / 2) + 1.
static int row_runs(int steps, int ntab, int* lo, int* hi, int* rows) {
  int m = 0;
  for (int g = 0; g < steps; ++g) {
    const int r = table_row(g, steps, ntab);
    if (m > 0 && rows[m - 1] == r) {
      hi[m - 1] = g + 1;
    } else {
      lo[m] = g;
      hi[m] = g + 1;
      rows[m] = r;
      ++m;
    }
  }
  return m;
}

#ifdef __CUDACC__
template <int VEC, int NOFF, int VAR>
__global__ void __launch_bounds__(SF_THREADS)
    sf_table(const float* x, float* out, const float* __restrict__ tab,
             const Row prm, long long n, int steps, int ntab, int g0, int g1,
             int chunk) {
  extern __shared__ float sf_smem[];
  const int lo = g0 + (int)blockIdx.y * chunk;
  const int hi = (lo + chunk < g1) ? lo + chunk : g1;
  table_block<VEC, NOFF, VAR>(x, out, tab, prm, sf_smem, n, steps, ntab, lo,
                              hi, blockIdx.x, threadIdx.x, blockDim.x);
}

template <int VEC, int NOFF, int VAR>
static int launch_range(const float* x, float* out, const float* tab,
                        const Row& prm, long long n, int steps, int ntab,
                        int g0, int g1, int chunk, cudaStream_t s) {
  const long long units = (n + VEC - 1) / VEC;
  const dim3 grid((unsigned)((units + SF_THREADS - 1) / SF_THREADS),
                  (unsigned)((g1 - g0 + chunk - 1) / chunk));
  const size_t smem = VAR == 2 ? sizeof(float) * ntab * NOFF : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sf_table<VEC, NOFF, VAR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sf_table<VEC, NOFF, VAR><<<grid, SF_THREADS, smem, s>>>(
      x, out, tab, prm, n, steps, ntab, g0, g1, chunk);
  return (int)cudaGetLastError();
}

// Returns the number of kernels launched, or a CUDA error as a negative
// value.
template <int VEC, int NOFF>
static int launch_variant(const float* x, float* out, const float* tab,
                          const float* tab_host, long long n, int steps,
                          int ntab, int variant, int chunk, cudaStream_t s) {
  Row prm;
  std::memset(&prm, 0, sizeof(prm));
  int rc;
  switch (variant) {
    case 0:
      rc = launch_range<VEC, NOFF, 0>(x, out, tab, prm, n, steps, ntab, 0,
                                      steps, chunk, s);
      return rc != 0 ? -rc : 1;
    case 1: {
      cudaError_t e = cudaMemcpyToSymbolAsync(
          sf_ctab, tab, sizeof(float) * ntab * NOFF, 0,
          cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return -(int)e;
      rc = launch_range<VEC, NOFF, 1>(x, out, tab, prm, n, steps, ntab, 0,
                                      steps, chunk, s);
      return rc != 0 ? -rc : 1;
    }
    case 2:
      rc = launch_range<VEC, NOFF, 2>(x, out, tab, prm, n, steps, ntab, 0,
                                      steps, chunk, s);
      return rc != 0 ? -rc : 1;
    default: {
      int lo[SF_MAX_RUNS], hi[SF_MAX_RUNS], rows[SF_MAX_RUNS];
      const int m = row_runs(steps, ntab, lo, hi, rows);
      for (int r = 0; r < m; ++r) {
        for (int d = 0; d < NOFF; ++d)
          prm.w[d] = tab_host[rows[r] * NOFF + d];
        rc = launch_range<VEC, NOFF, 3>(x, out, tab, prm, n, steps, ntab,
                                        lo[r], hi[r], chunk, s);
        if (rc != 0) return -rc;
      }
      return m;
    }
  }
}

// tab (device) for variants 0-2, tab_host (host) for variant 3; the
// wrapper checks ntab, noff and the sizes.  Returns the number of kernels
// launched (param: one per run of rows), or a CUDA error as a negative
// value (-cudaErrorInvalidValue for a term count not built).
extern "C" int sf_table_read_launch(const void* tab, const void* tab_host,
                                    const void* x, void* out, int ntab,
                                    int noff, long long n, int steps,
                                    int variant, int vec, int chunk,
                                    void* stream) {
  const float* t = (const float*)tab;
  const float* th = (const float*)tab_host;
  const float* xs = (const float*)x;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define SF_CASE(N_)                                                        \
  if (noff == N_)                                                          \
    return vec == 4 ? launch_variant<4, N_>(xs, o, t, th, n, steps, ntab,  \
                                            variant, chunk, s)             \
                    : launch_variant<1, N_>(xs, o, t, th, n, steps, ntab,  \
                                            variant, chunk, s);
  SF_NOFFS(SF_CASE)
#undef SF_CASE
  return -(int)cudaErrorInvalidValue;
}
#else
template <int VEC, int NOFF>
static void host_variant(const float* x, float* out, const float* tab,
                         long long n, int steps, int ntab, int variant,
                         int chunk) {
  static float stab[SF_CONST_FLOATS];
  Row prm;
  std::memset(&prm, 0, sizeof(prm));
  if (variant == 1) std::memcpy(sf_ctab, tab, sizeof(float) * ntab * NOFF);
  int lo[SF_MAX_RUNS], hi[SF_MAX_RUNS], rows[SF_MAX_RUNS];
  int m = 1;
  lo[0] = 0;
  hi[0] = steps;
  if (variant == 3) m = row_runs(steps, ntab, lo, hi, rows);
  const long long tiles = ((n + VEC - 1) / VEC + SF_THREADS - 1) / SF_THREADS;
  for (int r = 0; r < m; ++r) {
    if (variant == 3)
      for (int d = 0; d < NOFF; ++d) prm.w[d] = tab[rows[r] * NOFF + d];
    for (int g0 = lo[r]; g0 < hi[r]; g0 += chunk) {
      const int g1 = (g0 + chunk < hi[r]) ? g0 + chunk : hi[r];
      for (long long bx = 0; bx < tiles; ++bx) {
        for (float& v : stab) v = NAN;
        switch (variant) {
          case 0:
            table_block<VEC, NOFF, 0>(x, out, tab, prm, stab, n, steps, ntab,
                                      g0, g1, bx, 0, 1);
            break;
          case 1:
            table_block<VEC, NOFF, 1>(x, out, tab, prm, stab, n, steps, ntab,
                                      g0, g1, bx, 0, 1);
            break;
          case 2:
            table_block<VEC, NOFF, 2>(x, out, tab, prm, stab, n, steps, ntab,
                                      g0, g1, bx, 0, 1);
            break;
          default:
            table_block<VEC, NOFF, 3>(x, out, tab, prm, stab, n, steps, ntab,
                                      g0, g1, bx, 0, 1);
        }
      }
    }
  }
}

// The same variants over host arrays; returns -1 for a term count not
// built.
extern "C" int sf_table_read_host(const void* tab, const void* x, void* out,
                                  int ntab, int noff, long long n, int steps,
                                  int variant, int vec, int chunk) {
  const float* t = (const float*)tab;
  const float* xs = (const float*)x;
  float* o = (float*)out;
#define SF_CASE(N_)                                                          \
  if (noff == N_) {                                                          \
    if (vec == 4)                                                            \
      host_variant<4, N_>(xs, o, t, n, steps, ntab, variant, chunk);         \
    else                                                                     \
      host_variant<1, N_>(xs, o, t, n, steps, ntab, variant, chunk);         \
    return 0;                                                                \
  }
  SF_NOFFS(SF_CASE)
#undef SF_CASE
  return -1;
}
#endif
