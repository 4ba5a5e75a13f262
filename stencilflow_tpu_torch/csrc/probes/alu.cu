// P1, the FP32 issue ceiling: UNROLL unrolled elementwise ops per step on
// one accumulator per thread, for `steps` steps, with no memory traffic
// in the steady state.
//
// Replaces scripts/vpu_ceiling.py:238 build (pallas_call :240; body
// :46-235), which applies U whole-block ops per grid step to a
// VMEM-resident (512, 1024) f32 accumulator.  On the H100 the counterpart
// of a VMEM-resident block is a register per thread: each thread keeps
// its accumulator and the operands c and d in registers, so the rate is
// bound by instruction issue (132 SMs x 128 FP32 lanes x ~1.98 GHz =
// 33.5e12 single-instruction ops/s on the data sheet), and the launch
// fills every SM to its 2048 resident threads so that dependent chains
// hide the FP32 latency.  The result is written out, so nothing is dead
// code.  Built with the port's flags (-fmad=false, no fast math), as the
// generated kernels are: `a * c + d` is then two instructions, and
// OP_FMA_FUSED (explicit fmaf) measures the one-instruction form.
//
// The shared-memory variant (smem = 1, add only) reads the accumulator
// from shared memory and writes it back around every op, behind a
// __syncthreads, as the panel and spilled stream kernels store every
// stage: the counterpart of the TPU's VMEM-pass rate
// (config.TPU_VPU_PASS_RATE) and the reachable bound for such kernels.
//
// The script's variant bodies follow the same per-thread rule: mul4 (four
// multiply chains), expr_jac2d (the 4-op jacobi2d stage), the three
// formulations of the hdiff flux limiter (expr_lim_sel, _mask, _minmax:
// 7 ops each), and selc / maskmul (a hoisted mask applied by a select or
// by a multiply).  expr_jac2d_shift reads its operands from its
// neighbours: each block of 256 threads owns a 16 x 16 plane in shared
// memory, and every application stores the plane, synchronises, sums the
// four shifted reads (the script's concat fill: an edge reads itself)
// and synchronises again, the counterpart of the TPU's shifted copies and
// ring store.
//
// nvcc (backend/build.py's flags) builds sf_alu_launch; g++ (no
// __CUDACC__) builds sf_alu_host, which runs every thread in turn over
// the same per-thread body.
#include <cmath>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SF_DEV __device__ __forceinline__
#define SF_SYNC() __syncthreads()
#else
#define SF_DEV static inline
#define SF_SYNC()
using std::fmaf;
#endif

#define SF_ALU_UNROLL 64

// op ids: the order of probes/alu_ceiling.py OPS
enum {
  OP_ADD, OP_ADD2, OP_MUL, OP_FMA, OP_FMA_FUSED, OP_MIXED, OP_DIV, OP_DIVC,
  OP_SQRT, OP_EXP, OP_SELECT, OP_MIN, OP_SIN, OP_COS, OP_TAN, OP_TANH,
  OP_LOG, OP_ABS, OP_ADD4, OP_FMA4, OP_ADD8, OP_EXPR_JAC, OP_EXPR_HS,
  OP_MUL4, OP_EXPR_JAC2D, OP_EXPR_JAC2D_SHIFT, OP_EXPR_LIM_SEL,
  OP_EXPR_LIM_MASK, OP_EXPR_LIM_MINMAX, OP_SELC, OP_MASKMUL,
  OP_COUNT
};

// One op on the accumulator; `u` (the unrolled index) picks the operand
// where the TPU script alternates c and d.
template <int OP>
SF_DEV float alu_op(float a, float c, float d, int u) {
  switch (OP) {
    case OP_ADD: return a + ((u & 1) ? d : c);
    case OP_ADD2: return a + a;
    case OP_MUL: return a * ((u & 1) ? d : c);
    case OP_FMA: return a * c + d;
    case OP_FMA_FUSED: return fmaf(a, c, d);
    case OP_MIXED: return (u & 1) ? a * c : a + d;
    case OP_DIV: return c / a;
    case OP_DIVC: return a / ((u & 1) ? 0.9999999f : 1.0000001f);
    case OP_SQRT: return sqrtf(a);
    case OP_EXP: return expf(-a);
    case OP_SELECT: return a > c ? d : a;
    case OP_MIN: return fminf(a, (u & 1) ? d : c);
    case OP_SIN: return sinf(a);
    case OP_COS: return cosf(a);
    case OP_TAN: return tanf(a * 1e-3f);
    case OP_TANH: return tanhf(a);
    case OP_LOG: return logf(a + 1.0f);
    // abs(abs(a)) folds to abs(a): the probe takes abs of a difference
    case OP_ABS: return fabsf(a - ((u & 1) ? d : c));
    default: return a;
  }
}

// The per-thread body: `steps` steps of UNROLL ops from x, c = x *
// 0.999993, d = x * 1e-7.  K-chain ops (add4, fma4, add8) keep K
// independent accumulators and sum them at the end; expr_jac (8 ops) and
// expr_hs (20 ops) are stage-shaped expressions over five operands.
template <int OP>
SF_DEV float alu_thread(float x, int steps) {
  const float c = x * 0.999993f;
  const float d = x * 1e-7f;
  if (OP == OP_ADD4 || OP == OP_FMA4 || OP == OP_ADD8 || OP == OP_MUL4) {
    const int K = OP == OP_ADD8 ? 8 : 4;
    float ch[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ch[k] = x * (1.0f + 1e-6f * (float)k);
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < SF_ALU_UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (OP == OP_FMA4)
            ch[k] = ch[k] * c + d;
          else if (OP == OP_MUL4)
            ch[k] = ch[k] * (((u + k) & 1) ? d : c);
          else
            ch[k] = ch[k] + (((u + k) & 1) ? d : c);
        }
      }
    }
    float a = ch[0];
#pragma unroll
    for (int k = 1; k < K; ++k) a = a + ch[k];
    return a;
  }
  float a = x;
  if (OP == OP_EXPR_LIM_SEL || OP == OP_EXPR_LIM_MASK ||
      OP == OP_EXPR_LIM_MINMAX) {
    // flx = lap[j+1] - lap[j]; flx = 0 where flx * dq > 0 (q stands for
    // the neighbour, lap for the carried value)
    const float q = c;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < SF_ALU_UNROLL; ++u) {
        float flx = ((u & 1) ? q : a) - a * 0.999f;
        const float dq = q - a * 1.001f;
        const float p = flx * dq;
        if (OP == OP_EXPR_LIM_SEL)
          flx = p > 0.0f ? 0.0f : flx;
        else if (OP == OP_EXPR_LIM_MASK)
          flx = flx * (p <= 0.0f ? 1.0f : 0.0f);
        else   // differs from the other two where dq == 0, by design
          flx = dq > 0.0f ? fminf(flx, 0.0f) : fmaxf(flx, 0.0f);
        a = a * 0.5f + flx;
      }
    }
    return a;
  }
  if (OP == OP_SELC || OP == OP_MASKMUL) {
    const bool m = c > d;   // the compare, hoisted
    const float mf = m ? 1.0f : 0.0f, nf = 1.0f - mf;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < SF_ALU_UNROLL; ++u) {
        if (OP == OP_SELC)
          a = (u & 1) ? (m ? a : c) : (m ? d : a);
        else
          a = a * ((u & 1) ? nf : mf);
      }
    }
    return a;
  }
  if (OP == OP_EXPR_JAC || OP == OP_EXPR_HS || OP == OP_EXPR_JAC2D) {
    const float b0 = c * 0.9f, b1 = c * 0.91f, b2 = c * 0.92f,
                b3 = c * 0.93f, b4 = d;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int u = 0; u < SF_ALU_UNROLL; ++u) {
        if (OP == OP_EXPR_JAC)
          a = 0.142857f * (a + b0 + b1 + b2 + b3 + b4 + a * 1e-7f);
        else if (OP == OP_EXPR_JAC2D)
          a = 0.25f * (a + b0 + b1 + b2);
        else
          a = a + 0.01f * (b0 + 0.1f * (b1 + b2 - 2.0f * a)
                           + 0.1f * (b3 + b4 - 2.0f * a)
                           + 0.1f * (b1 + b3 - 2.0f * a)
                           + 0.0001f * (80.0f - a));
      }
    }
    return a;
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < SF_ALU_UNROLL; ++u) a = alu_op<OP>(a, c, d, u);
  }
  return a;
}

// The shared-memory variant of add: every op loads the accumulator from
// this thread's slot, adds, stores it back, then the block synchronises.
SF_DEV float alu_thread_smem(float x, int steps, volatile float* slot) {
  const float c = x * 0.999993f;
  const float d = x * 1e-7f;
  *slot = x;
  SF_SYNC();
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < SF_ALU_UNROLL; ++u) {
      const float a = *slot;
      *slot = a + ((u & 1) ? d : c);
      SF_SYNC();
    }
  }
  return *slot;
}

// expr_jac2d_shift on one 16 x 16 plane: thread `tid`'s cell, its four
// shifted reads (an edge reads itself, the script's concat fill), the
// sum in the script's order
#define SF_SHIFT_SIDE 16
SF_DEV float alu_shift_cell(const float* t, const int tid) {
  const int r = tid / SF_SHIFT_SIDE, k = tid % SF_SHIFT_SIDE;
  const float jm = t[r < SF_SHIFT_SIDE - 1 ? tid + SF_SHIFT_SIDE : tid];
  const float jp = t[r > 0 ? tid - SF_SHIFT_SIDE : tid];
  const float km = t[k < SF_SHIFT_SIDE - 1 ? tid + 1 : tid];
  const float kp = t[k > 0 ? tid - 1 : tid];
  return 0.25f * (jm + jp + km + kp);
}

#define SF_ALU_OPS(X)                                                      \
  X(OP_ADD) X(OP_ADD2) X(OP_MUL) X(OP_FMA) X(OP_FMA_FUSED) X(OP_MIXED)     \
  X(OP_DIV) X(OP_DIVC) X(OP_SQRT) X(OP_EXP) X(OP_SELECT) X(OP_MIN)         \
  X(OP_SIN) X(OP_COS) X(OP_TAN) X(OP_TANH) X(OP_LOG) X(OP_ABS) X(OP_ADD4)  \
  X(OP_FMA4) X(OP_ADD8) X(OP_EXPR_JAC) X(OP_EXPR_HS) X(OP_MUL4)            \
  X(OP_EXPR_JAC2D) X(OP_EXPR_LIM_SEL) X(OP_EXPR_LIM_MASK)                  \
  X(OP_EXPR_LIM_MINMAX) X(OP_SELC) X(OP_MASKMUL)

#ifdef __CUDACC__
template <int OP>
__global__ void __launch_bounds__(256)
sf_alu(const float* __restrict__ x, float* __restrict__ out, int n,
       int steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) out[t] = alu_thread<OP>(x[t], steps);
}

__global__ void __launch_bounds__(256)
sf_alu_smem(const float* __restrict__ x, float* __restrict__ out, int n,
            int steps) {
  __shared__ float acc[256];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of the block takes part in the barriers; threads past
  // n work on a copy of element 0 and write nothing
  const float r = alu_thread_smem(x[t < n ? t : 0], steps,
                                  acc + threadIdx.x);
  if (t < n) out[t] = r;
}

// one block a 16 x 16 plane (n a multiple of 256)
__global__ void __launch_bounds__(256)
sf_alu_shift(const float* __restrict__ x, float* __restrict__ out,
             int steps) {
  __shared__ float t[256];
  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * 256 + tid;
  float a = x[i];
  for (int s = 0; s < steps; ++s) {
#pragma unroll 4
    for (int u = 0; u < SF_ALU_UNROLL; ++u) {
      t[tid] = a;   // the store
      __syncthreads();
      a = alu_shift_cell(t, tid);
      __syncthreads();
    }
  }
  out[i] = a;
}

// 256 threads per block, one element per thread.  Returns
// cudaGetLastError(), or -1 for an op id or variant it does not have
// (expr_jac2d_shift: n not a multiple of 256).
extern "C" int sf_alu_launch(const void* x, void* out, int n, int op,
                             int steps, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + 255) / 256;
  const float* src = (const float*)x;
  float* dst = (float*)out;
  if (smem) {
    if (op != OP_ADD) return -1;
    sf_alu_smem<<<blocks, 256, 0, s>>>(src, dst, n, steps);
    return (int)cudaGetLastError();
  }
  if (op == OP_EXPR_JAC2D_SHIFT) {
    if (n % 256) return -1;
    sf_alu_shift<<<n / 256, 256, 0, s>>>(src, dst, steps);
    return (int)cudaGetLastError();
  }
  switch (op) {
#define SF_CASE(OP) \
    case OP: sf_alu<OP><<<blocks, 256, 0, s>>>(src, dst, n, steps); break;
    SF_ALU_OPS(SF_CASE)
#undef SF_CASE
    default: return -1;
  }
  return (int)cudaGetLastError();
}
#else
extern "C" int sf_alu_host(const void* x, void* out, int n, int op,
                           int steps, int smem) {
  const float* src = (const float*)x;
  float* dst = (float*)out;
  if (smem) {
    if (op != OP_ADD) return -1;
    float slot;
    for (int t = 0; t < n; ++t)
      dst[t] = alu_thread_smem(src[t], steps, &slot);
    return 0;
  }
  if (op == OP_EXPR_JAC2D_SHIFT) {
    if (n % 256) return -1;
    float cur[256], nxt[256];
    for (int b = 0; b < n / 256; ++b) {
      for (int t = 0; t < 256; ++t) cur[t] = src[b * 256 + t];
      for (int s = 0; s < steps * SF_ALU_UNROLL; ++s) {
        for (int t = 0; t < 256; ++t) nxt[t] = alu_shift_cell(cur, t);
        for (int t = 0; t < 256; ++t) cur[t] = nxt[t];
      }
      for (int t = 0; t < 256; ++t) dst[b * 256 + t] = cur[t];
    }
    return 0;
  }
  for (int t = 0; t < n; ++t) {
    switch (op) {
#define SF_CASE(OP) case OP: dst[t] = alu_thread<OP>(src[t], steps); break;
      SF_ALU_OPS(SF_CASE)
#undef SF_CASE
      default: return -1;
    }
  }
  return 0;
}
#endif
