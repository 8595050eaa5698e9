// f32 products on the tensor cores in 3xTF32, shared by ssd_scan.cu (K4)
// and the f32 face of flash_attention.cu (K3). Plain TF32 keeps about
// three decimal digits, short of the f32 paths' 1e-4 tolerance; 3xTF32
// keeps about f32's accuracy: each f32 operand x = big + small with
// big = tf32(x) and small = tf32(x - big), and a product takes
// a_small b_big + a_big b_small + a_big b_big (the dropped a_small b_small
// is ~2^-22 of it), summed in f32 by mma.sync.m16n8k8.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), g = lane / 4,
// t = lane % 4: A a[0] (row g, col t), a[1] (row g + 8, col t), a[2]
// (row g, col t + 4), a[3] (row g + 8, col t + 4); B b[0] (k t, col g),
// b[1] (k t + 4, col g); C c[0..1] (row g, cols 2t, 2t + 1), c[2..3]
// (row g + 8, the same cols): the C layout of the bf16 m16n8k16.
#pragma once

namespace tf32 {

__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// d += a b for one 16 x 8 x 8 tile (fragments in mma.sync's layout)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, from the split operands: the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4],
                                           const unsigned (&b_big)[2],
                                           const unsigned (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

}  // namespace tf32
