// Pairwise squared euclidean distances, out[i, j] = |a_i|^2 + |b_j|^2 - 2 a_i.b_j,
// for a [n, d] and b [m, d] in float32, row-major and contiguous.
//
// Replaces the Pallas TPU kernel ocl_tpu/ops/pallas/distance.py:_kernel, which
// holds both operands in VMEM in one padded block and runs the cross term on
// the MXU. Its caller is the ASER KNN-SV scoring (ocl_tpu_torch/ops/knn_sv.py),
// at n, m <= 210 and d = 160 on the CIFAR-100 recipe (about 7 MFLOP a call).
// At those sizes the kernel is bound by launch latency and by a grid of few,
// tiny tiles, not by FLOPs or bytes, so the design is the simple one:
//   * one 16x16 thread block per 16x16 output tile, one output per thread;
//   * the block walks d in chunks of 32, staging its 16 rows of a and 16 rows
//     of b in shared memory (padded by one float against bank conflicts);
//   * the cross term and both row norms accumulate in fp32 with fmaf: no
//     TF32, no tensor cores. Each chunk sums into a fresh partial that is then
//     added to the total, which keeps the rounding error of the long positive
//     norm sums down at large d;
//   * ragged edges are masked here (zeros staged past n, m and d), so the
//     wrapper makes no padded copies, where the TPU version makes two;
//   * the epilogue is (a2 + b2) - 2 * cross, the TPU kernel's order, with
//     the _rn intrinsics so the compiler contracts nothing into an FMA.
// The kernel launches on the caller's stream, allocates nothing, and the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;

__global__ void pairwise_sqdist_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out,
                                       int n, int m, int d) {
    __shared__ float a_s[kTile][kChunk + 1];
    __shared__ float b_s[kTile][kChunk + 1];

    const int tx = threadIdx.x;             // column of the tile: a row of b
    const int ty = threadIdx.y;             // row of the tile: a row of a
    const int row0 = blockIdx.y * kTile;
    const int col0 = blockIdx.x * kTile;
    const int tid = ty * kTile + tx;

    float cross = 0.f, a2 = 0.f, b2 = 0.f;
    for (int k0 = 0; k0 < d; k0 += kChunk) {
        for (int i = tid; i < kTile * kChunk; i += kTile * kTile) {
            const int r = i / kChunk;
            const int c = i % kChunk;
            const int k = k0 + c;
            const int ar = row0 + r;
            const int br = col0 + r;
            a_s[r][c] = (ar < n && k < d) ? a[static_cast<long long>(ar) * d + k] : 0.f;
            b_s[r][c] = (br < m && k < d) ? b[static_cast<long long>(br) * d + k] : 0.f;
        }
        __syncthreads();
        float pc = 0.f, pa = 0.f, pb = 0.f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
            const float av = a_s[ty][c];
            const float bv = b_s[tx][c];
            pc = fmaf(av, bv, pc);
            pa = fmaf(av, av, pa);
            pb = fmaf(bv, bv, pb);
        }
        cross += pc;
        a2 += pa;
        b2 += pb;
        __syncthreads();
    }

    const int row = row0 + ty;
    const int col = col0 + tx;
    if (row < n && col < m) {
        out[static_cast<long long>(row) * m + col] =
            __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.f, cross));
    }
}

}  // namespace

extern "C" int ocl_pairwise_sqdist_f32(const void* a, const void* b, void* out,
                                       int n, int m, int d, void* stream) {
    const dim3 block(kTile, kTile);
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    pairwise_sqdist_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, m, d);
    return static_cast<int>(cudaGetLastError());
}
