// Pairwise squared euclidean distances, out[i, j] = |a_i|^2 + |b_j|^2 - 2 a_i.b_j,
// for a [n, d] and b [m, d] in float32, row-major and contiguous; or, in one
// launch, for `points` such pairs stored back to back, a [points, n, d] and
// b [points, m, d] into out [points, n, m] (the stacked runs' batched call).
//
// Replaces the Pallas TPU kernel ocl_tpu/ops/pallas/distance.py:_kernel, which
// holds both operands in VMEM in one padded block and runs the cross term on
// the MXU. Its caller is ASER's KNN-SV scoring (ocl_tpu_torch/ops/knn_sv.py).
//
// What bounds it. At the main path's shapes the work is 0.07-14.2 MFLOP and
// 20-445 KB a call. The roofline bound, the larger of 2nmd + 2(n+m)d FLOP at
// 67 TFLOP/s (fp32) and 4(nd + md + nm) bytes at 3.35 TB/s (H100 SXM, 700 W):
//   30 x 30 x 160     12.5 ns  bytes       synthetic ASER update
//   10 x 20 x 160      6.0 ns  bytes       synthetic adversarial retrieval
//   20 x 20 x 160      8.1 ns  bytes       synthetic cooperative retrieval
//   210 x 210 x 160   0.21 us  FLOPs       CIFAR-100 update
//   10 x 200 x 160    42.5 ns  bytes       CIFAR-100 adversarial retrieval
//   200 x 200 x 160   0.19 us  FLOPs       CIFAR-100 cooperative retrieval
// All lie far under the card's launch floor (a one-element fill replayed in a
// CUDA graph takes about 0.9-1.1 us), so the kernel is bound by latency: of
// the launch, of each dependent round trip to memory, of each dependent chain
// of adds. The design keeps each of those to one short step:
//   * One asynchronous copy round per block. A block owns kBlockM x kBlockN
//     outputs. Its threads copy the block's rows of a and of b over the whole
//     of d into shared memory with cp.async (16 bytes a copy), all copies in
//     flight at once, and wait once. At d = 160 that is 10 KB; 210 x 210 is
//     729 blocks, one wave on 132 SMs. Where the rows over all of d do not fit
//     in 227 KB, the block walks d in slabs with a ring of two: the copy of
//     slab s + 1 is in flight while slab s is summed. Above 48 KB the kernel is
//     opted in to the larger dynamic shared memory once per process.
//   * Register micro-tiles. A group of kLanes lanes owns a kTileM x kTileN
//     tile of outputs; lane l of the group reads 16-byte vectors l, l + kLanes,
//     ... of the tile's rows from shared memory (a group reads 128 contiguous
//     bytes of one row per access: no bank conflicts). One step has all of a
//     lane's reads in flight before its first fmaf (at d = 160, one step: 5
//     vectors of each of 5 rows); the bound check is left to a last, partial
//     step.
//   * Each row norm once, into shared memory. The block's kBlockM + kBlockN
//     rows are dealt over the groups, one a group; a group sums its row's
//     squares in the same step, with the same lane partition and the same
//     fmaf sequence as the cross products.
//   * An xor butterfly over the group's lanes adds the partial sums. Every
//     value goes through the same tree of lane pairs, and fp32 addition
//     commutes, so a row norm is added in exactly the order of that row's
//     cross products: a row against an identical row gives exactly 0.
//   * 16-byte copies where d % 4 == 0 and both row starts are 16-byte aligned,
//     else 4-byte copies (the plan's copy width). Past n and m a block copies
//     the last row again and stores nothing, so the wrapper makes no padded
//     copies.
//   * The epilogue is (a2 + b2) - 2 * cross, the TPU kernel's order, with the
//     _rn intrinsics so the compiler contracts nothing into an FMA.
// Tensor cores are deliberately not used. Parity needs fp32 (<= 1e-5 relative
// against the plain version), which on tensor cores means 3xTF32, three TF32
// products per term, and that would also break the exact zero above. At
// <= 14.2 MFLOP the fp32 pipes of 132 SMs finish the arithmetic in ~0.2 us.
// The tiling was chosen by device time at the main path's shapes (PERF.md).
//
// A point axis. Under torch.func.vmap (P stacked runs or grid points) the
// P products of one call are independent and equally shaped, so one launch
// takes them all: grid row blockIdx.y is the point, and a, b and out advance
// by that point's stride (n*d, m*d, n*m floats); the tiling above is that of
// each point. Where d % 4 == 0, a point's rows stay 16-byte aligned.
//
// The launch plan (tiling, copy width, slab, buffers, grid, points, threads,
// shared bytes) is computed in Python, ocl_tpu_torch/ops/distance.py::launch_plan, and
// passed in. The C entry checks it against the tiling built here, launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() so
// the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The one tiling; ops/distance.py holds the same constants.
constexpr int kBlockM = 8, kBlockN = 8;    // outputs of a block
constexpr int kTileM = 2, kTileN = 2;      // outputs of a lane group
constexpr int kLanes = 8;                  // lanes of a group: they split d
constexpr int kGroups = (kBlockM / kTileM) * (kBlockN / kTileN);
constexpr int kThreads = kGroups * kLanes;
constexpr int kRows = kBlockM + kBlockN;   // rows a block copies, one norm a group
constexpr int kCross = kTileM * kTileN;    // cross terms of a group
constexpr int kCopiers = kThreads / kRows; // threads that copy one row
constexpr int kSmemMax = 232448;           // dynamic shared bytes a block may opt in to
constexpr int kSmemDefault = 49152;        // and may use without opting in
constexpr int kMaxPoints = 65535;          // grid rows a launch may have (gridDim.y)
static_assert(kGroups == kRows, "each group sums one row norm");
static_assert(kCross + 1 <= kLanes, "one lane stores each sum of a group");
static_assert(kThreads % kRows == 0 && 32 % kLanes == 0, "rows and groups split evenly");

// The launch plan. The fields and their order are those of
// ocl_tpu_torch/ops/distance.py::LaunchPlan.
struct LaunchPlan {
    int n, m, d;
    int block_m, block_n;  // outputs of a block
    int tile_m, tile_n;    // outputs of a lane group
    int lanes;             // lanes of a group
    int vec;               // floats one copy moves: 4 (16 bytes) or 1
    int slab;              // floats of each row a copy round brings
    int buffers;           // 1: all of d in one round; 2: a ring of two slabs
    int threads, grid, smem_bytes;
    int points;            // products of one launch, one grid row each
};

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ void dot_into(float& acc, float4 x, float4 y) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
}
__device__ __forceinline__ void dot_into(float& acc, float x, float y) { acc = fmaf(x, y, acc); }
__device__ __forceinline__ void zero(float4& x) { x = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& x) { x = 0.f; }

template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VEC == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
    }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Copies floats [k0, k0 + width) of the block's rows into `stage` ([kRows][slab]):
// kCopiers threads to a row, each taking every kCopiers-th vector of it.
template <int VEC>
__device__ __forceinline__ void copy_slab(float* stage, const float* a, const float* b, int row0,
                                          int col0, int n, int m, int d, int slab, int k0,
                                          int width) {
    const int r = threadIdx.x / kCopiers;
    const float* src = r < kBlockM ? a + static_cast<long long>(min(row0 + r, n - 1)) * d
                                   : b + static_cast<long long>(min(col0 + r - kBlockM, m - 1)) * d;
    src += k0;
    float* dst = stage + r * slab;
    for (int c = threadIdx.x % kCopiers * VEC; c < width; c += kCopiers * VEC) {
        copy_async<VEC>(dst + c, src + c);  // the plan gives VEC = 4 only where d % 4 == 0
    }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
pairwise_sqdist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int n, int m, int d, int slab) {
    using T = typename Vec<VEC>::T;
    constexpr int kV = kCross + 1;  // the group's cross terms, then its row norm
    // vectors in flight per lane and row in one step: at d = 160 one 16-byte
    // step reads all 5 vectors of a lane
    constexpr int kUnroll = VEC == 4 ? 5 : 4;
    constexpr int kStep = kLanes * kUnroll;
    extern __shared__ float4 smem4[];
    float* const smem = reinterpret_cast<float*>(smem4);

    const long long point = blockIdx.y;
    a += point * n * d;
    b += point * m * d;
    out += point * n * m;
    const int g = threadIdx.x / kLanes;  // the group; it sums the norm of block row g
    const int l = threadIdx.x % kLanes;
    const int tiles_n = (m + kBlockN - 1) / kBlockN;
    const int row0 = blockIdx.x / tiles_n * kBlockM;
    const int col0 = blockIdx.x % tiles_n * kBlockN;
    const int ti = g / (kBlockN / kTileN) * kTileM;  // the group's tile, in block rows
    const int tj = g % (kBlockN / kTileN) * kTileN;

    const int slabs = slab > 0 ? (d + slab - 1) / slab : 0;
    const int ring = slabs > 1 ? 2 : 1;
    float* const norms = smem + ring * kRows * slab;  // [kRows]

    float v[kV] = {};
    if (slabs > 0) {
        copy_slab<VEC>(smem, a, b, row0, col0, n, m, d, slab, 0, min(slab, d));
        copy_commit();
    }
    for (int s = 0; s < slabs; ++s) {
        if (s + 1 < slabs) {
            const int k0 = (s + 1) * slab;
            copy_slab<VEC>(smem + (s + 1) % 2 * kRows * slab, a, b, row0, col0, n, m, d, slab, k0,
                           min(slab, d - k0));
            copy_commit();
            copy_wait<1>();
        } else {
            copy_wait<0>();
        }
        __syncthreads();
        const T* const st = reinterpret_cast<const T*>(smem + s % 2 * kRows * slab);
        const int sv = slab / VEC;                       // vectors of a staged row
        const int kv = min(slab, d - s * slab) / VEC;    // of them this slab holds
        // one step from vector k0 of each row; `edge` reads zeros past kv
        // (they add exactly 0)
        const auto step = [&](int k0, bool edge) {
            T av[kTileM][kUnroll], bv[kTileN][kUnroll], nv[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int k = k0 + u * kLanes;
                const bool in = !edge || k < kv;
#pragma unroll
                for (int i = 0; i < kTileM; ++i) {
                    if (in) av[i][u] = st[(ti + i) * sv + k]; else zero(av[i][u]);
                }
#pragma unroll
                for (int j = 0; j < kTileN; ++j) {
                    if (in) bv[j][u] = st[(kBlockM + tj + j) * sv + k]; else zero(bv[j][u]);
                }
                if (in) nv[u] = st[g * sv + k]; else zero(nv[u]);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
                for (int i = 0; i < kTileM; ++i) {
#pragma unroll
                    for (int j = 0; j < kTileN; ++j) dot_into(v[i * kTileN + j], av[i][u], bv[j][u]);
                }
                dot_into(v[kCross], nv[u], nv[u]);
            }
        };
        const int full = kv / kStep * kStep;
        for (int k0 = 0; k0 < full; k0 += kStep) step(k0 + l, false);
        if (full < kv) step(full + l, true);
        if (s + 2 < slabs) __syncthreads();  // the ring's next copy overwrites this slab
    }

    // After the butterfly every lane of the group holds every sum; lane q
    // stores sum q.
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2) {
#pragma unroll
        for (int q = 0; q < kV; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
    }
    if (l == kCross) norms[g] = v[kCross];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kCross; ++q) {
        const int i = ti + q / kTileN, j = tj + q % kTileN;
        if (l == q && row0 + i < n && col0 + j < m) {
            out[static_cast<long long>(row0 + i) * m + col0 + j] =
                __fsub_rn(__fadd_rn(norms[i], norms[kBlockM + j]), __fmul_rn(2.f, v[q]));
        }
    }
}

using Kernel = void (*)(const float*, const float*, float*, int, int, int, int);

// The kernel of the plan's copy width, or nullptr for a plan of another tiling.
Kernel kernel_for(const LaunchPlan& p) {
    if (p.block_m != kBlockM || p.block_n != kBlockN || p.tile_m != kTileM || p.tile_n != kTileN ||
        p.lanes != kLanes || p.threads != kThreads) {
        return nullptr;
    }
    if (p.vec == 4) return pairwise_sqdist_kernel<4>;
    if (p.vec == 1) return pairwise_sqdist_kernel<1>;
    return nullptr;
}

// The plan must be one this file builds, for these pointers: a plan that is
// not is refused rather than launched.
bool plan_fits(const LaunchPlan& p, const void* a, const void* b) {
    if (p.n < 1 || p.m < 1 || p.d < 0 || p.slab < 0 || p.points < 1 || p.points > kMaxPoints) {
        return false;
    }
    const long long blocks = static_cast<long long>((p.n + kBlockM - 1) / kBlockM) *
                             ((p.m + kBlockN - 1) / kBlockN);
    const bool aligned =
        ((reinterpret_cast<std::uintptr_t>(a) | reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
    const bool one_round = p.slab == p.d && p.buffers == 1;
    const bool ring = p.slab > 0 && p.slab < p.d && p.buffers == 2;
    const long long smem = 4LL * (static_cast<long long>(p.buffers) * kRows * p.slab + kRows);
    return p.grid == blocks && (one_round || ring) && p.smem_bytes == smem &&
           smem <= kSmemMax &&
           (p.vec == 1 || (p.vec == 4 && p.d % 4 == 0 && p.slab % 4 == 0 && aligned));
}

// Lets both kernels take up to kSmemMax bytes of dynamic shared memory; CUDA's
// default stops at 48 KB.
cudaError_t opt_in_large_smem() {
    const Kernel kernels[] = {pairwise_sqdist_kernel<4>, pairwise_sqdist_kernel<1>};
    for (Kernel k : kernels) {
        const cudaError_t e =
            cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

}  // namespace

// `plan` points to a LaunchPlan (a void pointer: the struct's internal linkage
// must not reach the C symbol).
extern "C" int ocl_pairwise_sqdist_f32(const void* a, const void* b, void* out,
                                       const void* plan, void* stream) {
    const LaunchPlan& p = *static_cast<const LaunchPlan*>(plan);
    const Kernel kernel = kernel_for(p);
    if (kernel == nullptr || !plan_fits(p, a, b)) return static_cast<int>(cudaErrorInvalidValue);
    if (p.smem_bytes > kSmemDefault) {
        static const cudaError_t opted = opt_in_large_smem();  // once per process
        if (opted != cudaSuccess) return static_cast<int>(opted);
    }
    kernel<<<dim3(p.grid, p.points), kThreads, p.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
        p.n, p.m, p.d, p.slab);
    return static_cast<int>(cudaGetLastError());
}

// Blocks of the plan's kernel that one SM of the current device holds at once
// (CUDA's occupancy calculator, at the plan's shared bytes), or -1 for a plan
// this file does not build.
extern "C" int ocl_pairwise_sqdist_blocks_per_sm(const void* plan) {
    const LaunchPlan& p = *static_cast<const LaunchPlan*>(plan);
    const Kernel kernel = kernel_for(p);
    int blocks = -1;
    if (kernel == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                 &blocks, kernel, kThreads, p.smem_bytes) != cudaSuccess) {
        return -1;
    }
    return blocks;
}
