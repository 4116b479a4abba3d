// Host build of the verify kernel's arithmetic (csrc/ed25519_core.cuh),
// compiled with a C++ compiler. The CPU tests hold its verdicts against the
// oracle and the plain PyTorch version, and, built with -DCBT_COUNT_OPS,
// it counts the field multiplications per signature behind the kernel's
// bound. The GPU path never loads it.
#include <stdint.h>

#ifdef CBT_COUNT_OPS
extern "C" {
long long cbt_fe_mul_count = 0, cbt_fe_sq_count = 0;
}
#endif

#include "ed25519_core.cuh"

extern "C" void cbt_host_verify(const int32_t* rows, int B,
                                const int32_t* base, int32_t* out) {
  const cbt::ge_niels* tbl = reinterpret_cast<const cbt::ge_niels*>(base);
  for (int col = 0; col < B; col++)
    out[col] = cbt::verify_column(rows, B, col, tbl);
}

extern "C" void cbt_host_op_counts(long long* mul, long long* sq) {
#ifdef CBT_COUNT_OPS
  *mul = cbt_fe_mul_count;
  *sq = cbt_fe_sq_count;
#else
  *mul = -1;
  *sq = -1;
#endif
}
