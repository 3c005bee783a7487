// Asynchronous global -> shared copies (Ampere's cp.async, on Hopper too),
// shared by wo_matmul.cu's tiled wo8 form and decode_attention.cu.
#pragma once
#include <stdint.h>

namespace jlt {

// one asynchronous copy of ch bytes (16, 8 or 4; !valid: zeros, the source
// not read), or a plain byte copy (ch 1: rows of odd byte length)
__device__ __forceinline__ void copy_async(void* dst, const void* src, int ch, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? ch : 0;
  if (ch == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (ch == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else if (ch == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    *static_cast<uint8_t*>(dst) = valid ? *static_cast<const uint8_t*>(src) : 0;
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the same for a run-time n in 0..3
__device__ __forceinline__ void copy_wait(int n) {
  if (n <= 0) copy_wait<0>();
  else if (n == 1) copy_wait<1>();
  else if (n == 2) copy_wait<2>();
  else copy_wait<3>();
}

// the widest copy (16, 8, 4 or 1 bytes) that divides an address or length
inline int copy_width(uintptr_t a) { return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1; }

}  // namespace jlt
