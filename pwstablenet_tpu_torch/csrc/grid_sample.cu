// Bilinear grid-sample kernels for Hopper (sm_90a), NHWC layout, with
// torch.nn.functional.grid_sample semantics.  Built by kernels/_build.py
// with nvcc into a shared library with a plain C interface and bound
// with ctypes by kernels/grid_sample.py.
//
// Replaces the three Pallas TPU kernels of
// pwstablenet_tpu/kernels/grid_sample_pallas.py:
//
//   grid_sample_f32       <- grid_sample_pallas (f32 sample; the
//                            cascade's inter-stage warp, float warps)
//   grid_sample_packed_u8 <- grid_sample_pallas_packed (uint8 RGB in,
//                            uint8 RGB out; the full-resolution output
//                            warp of the pipeline)
//   grid_sample_grad_f32  <- grid_sample_grad_pallas (d/dgrid of
//                            sum(cot * sample); the backward of the
//                            fused warp in training)
//
// Bound: all three are memory bound.  Each output pixel reads its grid
// entry (8 bytes), four taps of C values (and, for the gradient, C
// cotangent values) and writes C values (2 for the gradient), with a
// few dozen flops; at the main paths' shapes the least time on an H100
// SXM (3.35 TB/s) is
//   f32:    image 6.29 MB + grid 4.19 MB + out 6.29 MB  -> ~5.0 us
//   packed: image 22.1 MB + grid 59.0 MB + out 22.1 MB -> ~31 us
//   grad:   image 12.6 MB + grid 8.39 MB + cot 12.6 MB
//           + out 8.39 MB (16 x 256 x 256 x 3)          -> ~12.5 us
//
// Design: one thread per output pixel.  The thread loads its grid entry
// as one float2, computes the four tap addresses and bilinear weights
// once, and loops over the channels.  Taps are plain global-memory
// gathers that go through L1/L2: stabilization warps are smooth, so
// neighbouring threads read neighbouring pixels and the gathers coalesce
// well enough.  Unlike the TPU kernel there is no row window: any
// displacement is exact, and any H x W is taken as is.  Reflection
// padding is done by the wrapper (a pre-reflected grid sampled with
// border; the gradient is then multiplied by the reflection's sign).
// The gradient kernel needs no atomics: it produces no image gradient,
// only one float2 per output pixel, summed over the channels in the
// thread.  The arithmetic repeats the plain versions' order step for
// step (the library is built with -fmad=false), so a kernel and its
// plain version agree to float rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float unnormalize(float g, int size, int align_corners) {
    if (align_corners) return (g + 1.0f) * 0.5f * (float)(size - 1);
    return ((g + 1.0f) * (float)size - 1.0f) * 0.5f;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// image (B,H,W,C) f32, grid (B,Ho,Wo,2) f32 -> out (B,Ho,Wo,C) f32.
// zeros != 0: out-of-bounds taps contribute 0; else coordinates clamp
// to the border.
__global__ void __launch_bounds__(kThreads)
grid_sample_f32_kernel(const float* __restrict__ image,
                       const float2* __restrict__ grid,
                       float* __restrict__ out,
                       int B, int H, int W, int C, int Ho, int Wo,
                       int zeros, int align_corners) {
    const long long n = (long long)B * Ho * Wo;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int b = (int)(p / ((long long)Ho * Wo));

    const float2 g = grid[p];
    float x = unnormalize(g.x, W, align_corners);
    float y = unnormalize(g.y, H, align_corners);
    if (!zeros) {
        x = clampf(x, 0.0f, (float)(W - 1));
        y = clampf(y, 0.0f, (float)(H - 1));
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx1 = x - x0f;
    const float wy1 = y - y0f;
    const float wx0 = 1.0f - wx1;
    const float wy0 = 1.0f - wy1;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = x0 + 1, y1 = y0 + 1;

    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
    const float w00 = (vy0 && vx0) ? wy0 * wx0 : 0.0f;
    const float w01 = (vy0 && vx1) ? wy0 * wx1 : 0.0f;
    const float w10 = (vy1 && vx0) ? wy1 * wx0 : 0.0f;
    const float w11 = (vy1 && vx1) ? wy1 * wx1 : 0.0f;

    const int cx0 = clampi(x0, 0, W - 1), cx1 = clampi(x1, 0, W - 1);
    const int cy0 = clampi(y0, 0, H - 1), cy1 = clampi(y1, 0, H - 1);
    const float* base = image + (size_t)b * H * W * C;
    const float* t00 = base + ((size_t)cy0 * W + cx0) * C;
    const float* t01 = base + ((size_t)cy0 * W + cx1) * C;
    const float* t10 = base + ((size_t)cy1 * W + cx0) * C;
    const float* t11 = base + ((size_t)cy1 * W + cx1) * C;
    float* o = out + (size_t)p * C;
    for (int c = 0; c < C; ++c) {
        float v = __ldg(t00 + c) * w00;
        v = v + __ldg(t01 + c) * w01;
        v = v + __ldg(t10 + c) * w10;
        v = v + __ldg(t11 + c) * w11;
        o[c] = v;
    }
}

// image (B,H,W,3) uint8, grid (B,Ho,Wo,2) f32 -> out (B,Ho,Wo,3) uint8,
// border padding.  The three bytes of each tap are read once; each
// channel blends in f32 on the 0..255 scale, rounds half to even and
// saturates.
__global__ void __launch_bounds__(kThreads)
grid_sample_packed_u8_kernel(const uint8_t* __restrict__ image,
                             const float2* __restrict__ grid,
                             uint8_t* __restrict__ out,
                             int B, int H, int W, int Ho, int Wo,
                             int align_corners) {
    const long long n = (long long)B * Ho * Wo;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int b = (int)(p / ((long long)Ho * Wo));

    const float2 g = grid[p];
    const float x = clampf(unnormalize(g.x, W, align_corners), 0.0f, (float)(W - 1));
    const float y = clampf(unnormalize(g.y, H, align_corners), 0.0f, (float)(H - 1));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);

    const float w00 = (1.0f - fy) * (1.0f - fx);
    const float w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx);
    const float w11 = fy * fx;

    const uint8_t* base = image + (size_t)b * H * W * 3;
    const uint8_t* t00 = base + ((size_t)y0 * W + x0) * 3;
    const uint8_t* t01 = base + ((size_t)y0 * W + x1) * 3;
    const uint8_t* t10 = base + ((size_t)y1 * W + x0) * 3;
    const uint8_t* t11 = base + ((size_t)y1 * W + x1) * 3;
    uint8_t* o = out + (size_t)p * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float v = w00 * (float)__ldg(t00 + c);
        v = v + w01 * (float)__ldg(t01 + c);
        v = v + w10 * (float)__ldg(t10 + c);
        v = v + w11 * (float)__ldg(t11 + c);
        o[c] = (uint8_t)clampf(rintf(v), 0.0f, 255.0f);
    }
}

// d/dgrid of sum(cot * sample(image, grid)): image (B,H,W,C) f32, grid
// (B,Ho,Wo,2) f32, cot (B,Ho,Wo,C) f32 -> out (B,Ho,Wo,2) f32.  No image
// gradient.  The semantics are the TPU kernel's (grid_sample_pallas.py
// l.378-538):
// - zeros: each corner's weight and tap value are masked by its validity;
// - border: the coordinate is clipped; the column taps clamp into the
//   image, and the tap row below the last row reads 0 (the TPU kernel's
//   row window ends there; it matters only at y == H-1 exactly); the
//   gradient is zeroed where the UNCLIPPED coordinate lies outside the
//   closed range [0, size-1], so it is kept on the boundary itself.
__global__ void __launch_bounds__(kThreads)
grid_sample_grad_f32_kernel(const float* __restrict__ image,
                            const float2* __restrict__ grid,
                            const float* __restrict__ cot,
                            float2* __restrict__ out,
                            int B, int H, int W, int C, int Ho, int Wo,
                            int zeros, int align_corners) {
    const long long n = (long long)B * Ho * Wo;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int b = (int)(p / ((long long)Ho * Wo));

    const float2 g = grid[p];
    const float ux = unnormalize(g.x, W, align_corners);
    const float uy = unnormalize(g.y, H, align_corners);
    float x = ux, y = uy;
    if (!zeros) {
        x = clampf(x, 0.0f, (float)(W - 1));
        y = clampf(y, 0.0f, (float)(H - 1));
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = x0 + 1, y1 = y0 + 1;

    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
    const bool m00 = zeros ? (vy0 && vx0) : true;
    const bool m01 = zeros ? (vy0 && vx1) : true;
    const bool m10 = zeros ? (vy1 && vx0) : vy1;
    const bool m11 = zeros ? (vy1 && vx1) : vy1;

    const int cx0 = clampi(x0, 0, W - 1), cx1 = clampi(x1, 0, W - 1);
    const int cy0 = clampi(y0, 0, H - 1), cy1 = clampi(y1, 0, H - 1);
    const float* base = image + (size_t)b * H * W * C;
    const float* t00 = base + ((size_t)cy0 * W + cx0) * C;
    const float* t01 = base + ((size_t)cy0 * W + cx1) * C;
    const float* t10 = base + ((size_t)cy1 * W + cx0) * C;
    const float* t11 = base + ((size_t)cy1 * W + cx1) * C;
    const float* gp = cot + (size_t)p * C;
    float dgx = 0.0f, dgy = 0.0f;
    for (int c = 0; c < C; ++c) {
        const float a00 = m00 ? __ldg(t00 + c) : 0.0f;
        const float a01 = m01 ? __ldg(t01 + c) : 0.0f;
        const float a10 = m10 ? __ldg(t10 + c) : 0.0f;
        const float a11 = m11 ? __ldg(t11 + c) : 0.0f;
        const float gc = __ldg(gp + c);
        dgx = dgx + gc * ((1.0f - fy) * (a01 - a00) + fy * (a11 - a10));
        dgy = dgy + gc * ((1.0f - fx) * (a10 - a00) + fx * (a11 - a01));
    }
    if (!zeros) {
        if (!(ux >= 0.0f && ux <= (float)(W - 1))) dgx = 0.0f;
        if (!(uy >= 0.0f && uy <= (float)(H - 1))) dgy = 0.0f;
    }
    const float sx = align_corners ? 0.5f * (float)(W - 1) : 0.5f * (float)W;
    const float sy = align_corners ? 0.5f * (float)(H - 1) : 0.5f * (float)H;
    out[p] = make_float2(dgx * sx, dgy * sy);
}

inline unsigned int blocks_for(long long n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C interface.  Each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

extern "C" int pwst_grid_sample_f32(const void* image, const void* grid, void* out,
                                    int B, int H, int W, int C, int Ho, int Wo,
                                    int zeros, int align_corners, void* stream) {
    const long long n = (long long)B * Ho * Wo;
    if (n > 0) {
        grid_sample_f32_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)image, (const float2*)grid, (float*)out,
            B, H, W, C, Ho, Wo, zeros, align_corners);
    }
    return (int)cudaGetLastError();
}

extern "C" int pwst_grid_sample_packed_u8(const void* image, const void* grid, void* out,
                                          int B, int H, int W, int Ho, int Wo,
                                          int align_corners, void* stream) {
    const long long n = (long long)B * Ho * Wo;
    if (n > 0) {
        grid_sample_packed_u8_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)image, (const float2*)grid, (uint8_t*)out,
            B, H, W, Ho, Wo, align_corners);
    }
    return (int)cudaGetLastError();
}

extern "C" int pwst_grid_sample_grad_f32(const void* image, const void* grid,
                                         const void* cot, void* out,
                                         int B, int H, int W, int C, int Ho, int Wo,
                                         int zeros, int align_corners, void* stream) {
    const long long n = (long long)B * Ho * Wo;
    if (n > 0) {
        grid_sample_grad_f32_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)image, (const float2*)grid, (const float*)cot, (float2*)out,
            B, H, W, C, Ho, Wo, zeros, align_corners);
    }
    return (int)cudaGetLastError();
}
