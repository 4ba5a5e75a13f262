// The typed emitter's native bf16 / f16 operations against the float path
// they replace (backend/codegen.py, _BF16_MACROS and _HALF_MACROS, which
// probes/narrow_ops.py puts in front of this file): for every pair of
// 2-byte operands (a, b) and each of + - *, sf_bf_add / sf_bf_sub /
// sf_bf_mul (add.rn.bf16, ... on sm_90) against sf_f2bf(sf_bf2f(a) op
// sf_bf2f(b)), and sf_h_add / sf_h_sub / sf_h_mul (add.rn.f16, ...)
// against sf_f2h(sf_h2f(a) op sf_h2f(b)), compared as bit patterns, NaNs
// included.  It replaces no TPU kernel: it is the check that lets the
// narrow kernels compute in 2 bytes.  Bound by the float path's
// conversions (about 16 a clock per SM on compute capability 9.0).
//
// sf_narrow_ops(a0, rows, mism, ex): block x of the grid takes first
// operand a0 + x, its threads every second operand; mism[k] counts the
// mismatches of operation k (bf16 add, sub, mul, f16 add, sub, mul),
// ex[0] counts the mismatches recorded, ex[1 + 2 n], ex[2 + 2 n] (n < 16)
// hold (k << 16 | a, native << 16 | float path) of the first ones found.

#define SF_NOPS 6
#define SF_NEX 16

__device__ __forceinline__ void sf_note(const int k, const unsigned a,
                                        const unsigned short got,
                                        const unsigned short want,
                                        unsigned* m, unsigned* ex) {
  if (got == want) return;
  ++m[k];
  const unsigned n = atomicAdd(ex, 1u);
  if (n < SF_NEX) {
    ex[1 + 2 * n] = ((unsigned)k << 16) | a;
    ex[2 + 2 * n] = ((unsigned)got << 16) | want;
  }
}

__global__ void sf_narrow_ops_kernel(const unsigned a0,
                                     unsigned long long* mism,
                                     unsigned* ex) {
  const unsigned a = a0 + blockIdx.x;
  unsigned m[SF_NOPS] = {0, 0, 0, 0, 0, 0};
  const sf_bf16 ab = sf_bfk((unsigned short)a);
  const sf_half ah = sf_hk((unsigned short)a);
  const float abf = sf_bf2f(ab), ahf = sf_h2f(ah);
  for (unsigned b = threadIdx.x; b < 65536u; b += blockDim.x) {
    const sf_bf16 bb = sf_bfk((unsigned short)b);
    const sf_half bh = sf_hk((unsigned short)b);
    const float bbf = sf_bf2f(bb), bhf = sf_h2f(bh);
    sf_note(0, a, sf_bfu(sf_bf_add(ab, bb)), sf_bfu(sf_f2bf(abf + bbf)), m, ex);
    sf_note(1, a, sf_bfu(sf_bf_sub(ab, bb)), sf_bfu(sf_f2bf(abf - bbf)), m, ex);
    sf_note(2, a, sf_bfu(sf_bf_mul(ab, bb)), sf_bfu(sf_f2bf(abf * bbf)), m, ex);
    sf_note(3, a, sf_hu(sf_h_add(ah, bh)), sf_hu(sf_f2h(ahf + bhf)), m, ex);
    sf_note(4, a, sf_hu(sf_h_sub(ah, bh)), sf_hu(sf_f2h(ahf - bhf)), m, ex);
    sf_note(5, a, sf_hu(sf_h_mul(ah, bh)), sf_hu(sf_f2h(ahf * bhf)), m, ex);
  }
  for (int k = 0; k < SF_NOPS; ++k)
    if (m[k]) atomicAdd(mism + k, (unsigned long long)m[k]);
}

extern "C" int sf_narrow_ops(const unsigned a0, const unsigned rows,
                             unsigned long long* mism, unsigned* ex,
                             void* stream) {
  sf_narrow_ops_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(a0, mism, ex);
  return (int)cudaGetLastError();
}
