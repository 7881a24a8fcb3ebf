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
//           (twice that at the training shape, 16 x 256 x 256 x 3)
//   packed: image 22.1 MB + grid 59.0 MB + out 22.1 MB -> ~31 us
//   grad:   image 12.6 MB + grid 8.39 MB + cot 12.6 MB
//           + out 8.39 MB (16 x 256 x 256 x 3)          -> ~12.5 us
//
// What holds a sampler back on this card is less device memory than the
// work around each byte: the instructions that address, fetch, convert
// and blend it (the blend keeps the plain version's rounding, so no
// fused multiply-adds), and the loads the SM can keep in flight.  All
// three kernels are built for that:
// - Launch: a 3-D grid, x for column groups, y for rows, z for the
//   batch, so a thread finds its pixels with 32-bit arithmetic inside
//   its frame and no division.
// - Cache policy: the grid (and the gradient's cotangent) is read once
//   and the output written once, with the evict-first hints
//   (ld.global.cs / st.global.cs); the taps go through the read-only path
//   (ld.global.nc), so the image, which the taps read again and again,
//   stays in the 50 MB L2.
// - f32 sample: one thread per output pixel, so that neighbouring lanes
//   gather neighbouring taps and each warp instruction touches few
//   lines.  Its grid entry is one float2 (two floats in a view at an odd
//   float offset).  C = 3 is a template: where the two taps of a row are
//   adjacent (all but the clamped edges), the row pair is 6 contiguous
//   floats, fetched with three 8-byte loads, or four from the float
//   before where it is not 8-byte aligned: 6-8 tap loads a pixel instead
//   of 12.  Other channel counts loop over C.  Groups of 2 or 4 pixels a
//   thread were measured slower (PERF.md): fewer threads, and more
//   registers each.
// - d/dgrid: the f32 sample's design, with the cotangent as a third
//   stream.  One thread per output pixel; its grid entry is one float2
//   (two floats where it is not 8-byte aligned); at C = 3 its 12
//   cotangent bytes are a float2 and a float, in the order their
//   alignment allows, and the tap row pairs come in 8-byte loads, so a
//   pixel issues 9-11 loads instead of 16.  The masks are applied after
//   the loads: the clamped tap offsets always lie in the frame.  At C = 3
//   registers are capped at 32 (eight blocks on each SM), which was
//   measured 1 % faster on a smooth grid; two pixels a thread, 6 % slower
//   (PERF.md).  It needs no atomics: there is no image gradient, only one
//   float2 per output pixel, summed over the channels in the thread.  It
//   takes about twice its bound: a launch floor of ~6.3 us, then ~2.2 TB/s.
// - Packed uint8 sample: four adjacent output pixels a thread.  Their
//   grid entries load as two float4s, and their 12 output bytes store as
//   three 4-byte words.  A tap row pair (x0, x1) is 6 contiguous bytes at
//   3 * x0: it is fetched with one aligned 8-byte load, or two where the
//   bytes cross an 8-byte word, and taken apart in registers, so a pixel
//   issues 2-4 tap loads instead of 12 byte loads.  A second word is
//   loaded only where it holds bytes of the taps, so no load reads a word
//   that lies wholly outside the image; the tap offsets are 32-bit byte
//   offsets into the frame's aligned words.  align_corners is a template
//   parameter, so the kernel carries one coordinate mapping, not both
//   under predicates.  Registers are capped at 32 (eight blocks of 256
//   threads on each SM): the loads of more threads in flight were
//   measured to beat more loads in flight per thread.
// - The packed kernel's groups start at pixel indices (in the whole
//   output) that are multiples of the group size, so that whole groups
//   are aligned; a row whose first pixel is not such a multiple starts
//   with a short head group.  A group that is not whole (a row's head or
//   tail), or whose grid or output address is not aligned (a view at an
//   odd offset), takes the per-pixel path in the same kernel: scalar grid
//   loads and byte stores, the same arithmetic.
// There is no row window: the taps are gathers from global memory, so
// any displacement is exact, and any H x W and any output size Ho x Wo
// are taken as they are, up to the launch's limits (B <= 65535 frames,
// Ho <= 65535 * 8 rows; the C interface below refuses more).  (A
// shared-memory copy of each block's tap box, the TPU kernel's row window
// rethought, was not needed to bring the packed kernel within 2x of its
// bound; PERF.md.)
//
// Reflection padding is done by the wrapper (a pre-reflected grid
// sampled with border; the gradient is then multiplied by the
// reflection's sign).  The arithmetic of every kernel repeats its plain
// version's order step for step (the library is built with -fmad=false),
// so a kernel and its plain version agree bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
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

// ---------------------------------------------------------------------
// all three kernels: a 3-D launch of 32 x 8 thread blocks (column groups,
// rows, batch); grid (and cotangent) read and output written with
// evict-first hints (__ldcs / __stcs), taps through the read-only path
// (__ldg)
// ---------------------------------------------------------------------

constexpr int kBlockX = 32;   // column groups per block (one warp)
constexpr int kBlockY = 8;    // rows per block
static_assert(kBlockX * kBlockY == kThreads, "block shape");
constexpr int kPackedPixels = 4;  // 12 output bytes = three 4-byte words

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
    return ((uintptr_t)p & (uintptr_t)(bytes - 1)) == 0;
}

// Tap offsets (in floats, within the frame) and weights of one f32
// pixel; zeros != 0: out-of-bounds taps weigh 0, else coordinates clamp
// to the border.
struct F32Taps {
    int o00, o01, o10, o11;
    float w00, w01, w10, w11;
};

__device__ __forceinline__ F32Taps f32_taps(float gx, float gy, int H, int W, int C,
                                            int zeros, int align_corners) {
    float x = unnormalize(gx, W, align_corners);
    float y = unnormalize(gy, H, align_corners);
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
    F32Taps t;
    t.w00 = (vy0 && vx0) ? wy0 * wx0 : 0.0f;
    t.w01 = (vy0 && vx1) ? wy0 * wx1 : 0.0f;
    t.w10 = (vy1 && vx0) ? wy1 * wx0 : 0.0f;
    t.w11 = (vy1 && vx1) ? wy1 * wx1 : 0.0f;

    const int cx0 = clampi(x0, 0, W - 1), cx1 = clampi(x1, 0, W - 1);
    const int cy0 = clampi(y0, 0, H - 1), cy1 = clampi(y1, 0, H - 1);
    t.o00 = (cy0 * W + cx0) * C;
    t.o01 = (cy0 * W + cx1) * C;
    t.o10 = (cy1 * W + cx0) * C;
    t.o11 = (cy1 * W + cx1) * C;
    return t;
}

__device__ __forceinline__ float blend_f32(const float* __restrict__ img, const F32Taps& t,
                                           int c) {
    float v = __ldg(img + t.o00 + c) * t.w00;
    v = v + __ldg(img + t.o01 + c) * t.w01;
    v = v + __ldg(img + t.o10 + c) * t.w10;
    v = v + __ldg(img + t.o11 + c) * t.w11;
    return v;
}

// One pixel's grid entry: a float2, or two floats where it is not 8-byte
// aligned (a grid view at an odd float offset).
__device__ __forceinline__ void load_grid_entry(const float* gp, float& gx, float& gy) {
    if (aligned(gp, 8)) {
        const float2 g = __ldcs(reinterpret_cast<const float2*>(gp));
        gx = g.x;
        gy = g.y;
    } else {
        gx = __ldcs(gp);
        gy = __ldcs(gp + 1);
    }
}

// The 6 floats at p (two adjacent RGB taps) with 8-byte loads: three
// where p is 8-byte aligned, else four from the float before p.
__device__ __forceinline__ void load_pair(const float* p, float (&f)[6]) {
    const bool odd = ((uintptr_t)p >> 2) & 1;
    const float2* w = reinterpret_cast<const float2*>(p - (odd ? 1 : 0));
    const float2 a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2);
    const float2 d = odd ? __ldg(w + 3) : make_float2(0.0f, 0.0f);
    f[0] = odd ? a.y : a.x;
    f[1] = odd ? b.x : a.y;
    f[2] = odd ? b.y : b.x;
    f[3] = odd ? c.x : b.y;
    f[4] = odd ? c.y : c.x;
    f[5] = odd ? d.x : c.y;
}

// image (B,H,W,C) f32, grid (B,Ho,Wo,2) f32 -> out (B,Ho,Wo,C) f32, one
// thread per output pixel.  kC = 3: RGB, all taps loaded before the
// first store, a tap row pair as 8-byte loads where its two taps are
// adjacent; kC = 0: any C, read at run time.
template <int kC>
__global__ void __launch_bounds__(kThreads)
grid_sample_f32_kernel(const float* __restrict__ image,
                       const float* __restrict__ grid,
                       float* __restrict__ out,
                       int H, int W, int C, int Ho, int Wo,
                       int zeros, int align_corners) {
    static_assert(kC == 0 || kC == 3, "C = 3 or any C");
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= Wo || y >= Ho) return;
    const size_t pixel = ((size_t)blockIdx.z * Ho + y) * Wo + x;
    const int nc = kC > 0 ? kC : C;
    float gx, gy;
    load_grid_entry(grid + 2 * pixel, gx, gy);
    const float* img = image + (size_t)blockIdx.z * H * W * nc;
    float* o = out + pixel * nc;
    const F32Taps t = f32_taps(gx, gy, H, W, nc, zeros, align_corners);
    if constexpr (kC == 3) {
        float v[3];
        if (t.o01 == t.o00 + 3 && t.o11 == t.o10 + 3) {
            float r0[6], r1[6];
            load_pair(img + t.o00, r0);
            load_pair(img + t.o10, r1);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                float u = r0[c] * t.w00;
                u = u + r0[3 + c] * t.w01;
                u = u + r1[c] * t.w10;
                v[c] = u + r1[3 + c] * t.w11;
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) v[c] = blend_f32(img, t, c);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) __stcs(o + c, v[c]);
    } else {
        for (int c = 0; c < nc; ++c) __stcs(o + c, blend_f32(img, t, c));
    }
}

// The group of PX output pixels of a packed-kernel thread: columns
// x .. x+PX-1 of the row whose first pixel has index `row` in
// (B, Ho, Wo).  Groups start at pixel indices that are multiples of PX,
// so a row's first group starts at x = -(row % PX) and may be short.
struct Group {
    size_t first;  // index of the pixel at column x (x may be < 0)
    int x;
    bool whole;    // all PX pixels lie in the row
};

template <int PX>
__device__ __forceinline__ bool locate_group(int Ho, int Wo, Group& g) {
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (y >= Ho) return false;
    const size_t row = ((size_t)blockIdx.z * Ho + y) * Wo;
    const int lead = (int)(row % PX);
    g.x = (int)(blockIdx.x * kBlockX + threadIdx.x) * PX - lead;
    g.first = row - lead + (size_t)(g.x + lead);
    g.whole = g.x >= 0 && g.x + PX <= Wo;
    return g.x < Wo;
}

__device__ __forceinline__ bool in_row(const Group& g, int i, int Wo) {
    return g.x + i >= 0 && g.x + i < Wo;
}

// Grid entries of the group: PX/2 float4s for a whole, aligned group;
// else scalar loads, and (0, 0) for columns outside the row.
template <int PX>
__device__ __forceinline__ void load_grid(const float* __restrict__ grid, const Group& g,
                                          int Wo, float (&gx)[PX], float (&gy)[PX]) {
    static_assert(PX % 2 == 0, "whole float4s");
    const float* p = grid + 2 * g.first;
    if (g.whole && aligned(p, 16)) {
#pragma unroll
        for (int i = 0; i < PX / 2; ++i) {
            const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + i);
            gx[2 * i] = v.x;
            gy[2 * i] = v.y;
            gx[2 * i + 1] = v.z;
            gy[2 * i + 1] = v.w;
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const bool in = in_row(g, i, Wo);
        gx[i] = in ? __ldcs(p + 2 * i) : 0.0f;
        gy[i] = in ? __ldcs(p + 2 * i + 1) : 0.0f;
    }
}

// The bytes at byte t of the 8-byte words from `words` as two 4-byte
// words (bytes 0-3 and 4-7; those past the n-th, n <= 8, are
// unspecified): the word that holds byte t, and the next one only if the
// n bytes reach into it.
__device__ __forceinline__ void load_bytes(const uint2* __restrict__ words, unsigned int t,
                                           int n, unsigned int& lo, unsigned int& hi) {
    const uint2* w = words + (t >> 3);
    const unsigned int s = t & 7;
    const uint2 w0 = __ldg(w);
    const uint2 w1 = s + n > 8 ? __ldg(w + 1) : make_uint2(0u, 0u);
    // the three 4-byte words from the one that holds p
    const unsigned int u0 = s < 4 ? w0.x : w0.y;
    const unsigned int u1 = s < 4 ? w0.y : w1.x;
    const unsigned int u2 = s < 4 ? w1.x : w1.y;
    lo = __funnelshift_r(u0, u1, 8 * (s & 3));
    hi = __funnelshift_r(u1, u2, 8 * (s & 3));
}

// A frame of the packed image: its first byte as an offset (`skew` < 8)
// into the aligned 8-byte words from `words`.
struct Frame {
    const uint2* words;
    unsigned int skew;
};

// One uint8 RGB pixel, border padding, as 3 bytes in the low 24 bits:
// each channel blends in f32 on the 0..255 scale, rounds half to even
// and saturates.  kAlign: align_corners, a template so that the kernel
// carries one coordinate mapping, not both under predicates.
template <int kAlign>
__device__ __forceinline__ unsigned int sample_packed(const Frame& img, int H, int W,
                                                      float gx, float gy) {
    const float x = clampf(unnormalize(gx, W, kAlign), 0.0f, (float)(W - 1));
    const float y = clampf(unnormalize(gy, H, kAlign), 0.0f, (float)(H - 1));
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

    // each tap's RGB in the low 3 bytes of a word; a tap row pair
    // (x0, x1) is 6 contiguous bytes, or 3 at the right edge, where
    // x1 == x0 and the two taps are one
    const bool edge = x1 == x0;
    const unsigned int t0 = (unsigned int)(y0 * W + x0) * 3 + img.skew;
    const unsigned int t1 = t0 + (unsigned int)((y1 - y0) * W) * 3;
    unsigned int q00, q10, hi0, hi1;
    load_bytes(img.words, t0, edge ? 3 : 6, q00, hi0);
    load_bytes(img.words, t1, edge ? 3 : 6, q10, hi1);
    const unsigned int q01 = edge ? q00 : __funnelshift_r(q00, hi0, 24);
    const unsigned int q11 = edge ? q10 : __funnelshift_r(q10, hi1, 24);
    unsigned int rgb = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float v = w00 * (float)((q00 >> (8 * c)) & 0xff);
        v = v + w01 * (float)((q01 >> (8 * c)) & 0xff);
        v = v + w10 * (float)((q10 >> (8 * c)) & 0xff);
        v = v + w11 * (float)((q11 >> (8 * c)) & 0xff);
        // rint, then clamp to 0..255: the conversion rounds half to even
        // and takes negatives to 0
        rgb |= min(__float2uint_rn(v), 255u) << (8 * c);
    }
    return rgb;
}

// image (B,H,W,3) uint8, grid (B,Ho,Wo,2) f32 -> out (B,Ho,Wo,3) uint8,
// border padding.  A whole, aligned group of 4 pixels stores its 12
// bytes as three 4-byte words.  Eight blocks on each SM (registers
// capped at 32): more threads' loads in flight.
template <int kAlign>
__global__ void __launch_bounds__(kThreads, 8)
grid_sample_packed_u8_kernel(const uint8_t* __restrict__ image,
                             const float* __restrict__ grid,
                             uint8_t* __restrict__ out,
                             int H, int W, int Ho, int Wo) {
    constexpr int PX = kPackedPixels;
    Group g;
    if (!locate_group<PX>(Ho, Wo, g)) return;
    float gx[PX], gy[PX];
    load_grid<PX>(grid, g, Wo, gx, gy);
    const uintptr_t frame = (uintptr_t)(image + (size_t)blockIdx.z * H * W * 3);
    Frame img;
    img.words = reinterpret_cast<const uint2*>(frame & ~(uintptr_t)7);
    img.skew = (unsigned int)(frame & 7);
    unsigned int rgb[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) rgb[i] = sample_packed<kAlign>(img, H, W, gx[i], gy[i]);

    uint8_t* o = out + g.first * 3;
    if (g.whole && aligned(o, 4)) {
        unsigned int w[3] = {0, 0, 0};
#pragma unroll
        for (int k = 0; k < 3 * PX; ++k) {
            const unsigned int byte = (rgb[k / 3] >> (8 * (k % 3))) & 0xff;
            w[k / 4] |= byte << (8 * (k % 4));
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) __stcs(reinterpret_cast<unsigned int*>(o) + k, w[k]);
    } else {
#pragma unroll
        for (int i = 0; i < PX; ++i) {
            if (!in_row(g, i, Wo)) continue;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                __stcs(o + 3 * i + c, (uint8_t)((rgb[i] >> (8 * c)) & 0xff));
            }
        }
    }
}

// Blocks of a kernel's launch: groups of PX pixels along a row (one more
// where rows start off a multiple of PX), rows, batch.
dim3 launch_blocks(int B, int Ho, int Wo, int PX) {
    const int groups = Wo % PX == 0 ? Wo / PX : (Wo + 2 * PX - 2) / PX;
    return dim3((unsigned)((groups + kBlockX - 1) / kBlockX),
                (unsigned)((Ho + kBlockY - 1) / kBlockY), (unsigned)B);
}

// The kernels' limits: a frame indexes in 32 bits, and the launch's y
// and z dimensions (rows / kBlockY, batch) take at most 65535 blocks
// each.
bool launch_fits(int B, int Ho, long long frame_values) {
    return frame_values <= INT_MAX && B <= 65535 && Ho <= 65535 * kBlockY;
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
// One thread per output pixel, as the f32 sample.  kC = 3: RGB, the
// cotangent as a float2 and a float, a tap row pair as 8-byte loads where
// its two taps are adjacent (masked corners take 0 after the load: the
// clamped offsets always lie in the frame), and eight blocks on each SM
// (32 registers, no spills); kC = 0: any C, read at run time (it would
// spill at 32 registers).
template <int kC>
__global__ void __launch_bounds__(kThreads, kC == 3 ? 8 : 1)
grid_sample_grad_f32_kernel(const float* __restrict__ image,
                            const float* __restrict__ grid,
                            const float* __restrict__ cot,
                            float* __restrict__ out,
                            int H, int W, int C, int Ho, int Wo,
                            int zeros, int align_corners) {
    static_assert(kC == 0 || kC == 3, "C = 3 or any C");
    const int px = blockIdx.x * kBlockX + threadIdx.x;
    const int py = blockIdx.y * kBlockY + threadIdx.y;
    if (px >= Wo || py >= Ho) return;
    const size_t pixel = ((size_t)blockIdx.z * Ho + py) * Wo + px;
    const int nc = kC > 0 ? kC : C;
    float gx, gy;
    load_grid_entry(grid + 2 * pixel, gx, gy);

    const float ux = unnormalize(gx, W, align_corners);
    const float uy = unnormalize(gy, H, align_corners);
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
    const float* img = image + (size_t)blockIdx.z * H * W * nc;
    const int o00 = (cy0 * W + cx0) * nc, o01 = (cy0 * W + cx1) * nc;
    const int o10 = (cy1 * W + cx0) * nc, o11 = (cy1 * W + cx1) * nc;
    const float* cp = cot + pixel * nc;
    float dgx = 0.0f, dgy = 0.0f;
    if constexpr (kC == 3) {
        // the cotangent's 12 bytes: a float2 then a float where they start
        // 8-byte aligned (an even pixel of an aligned tensor), else a float
        // then a float2
        float g[3];
        if (aligned(cp, 8)) {
            const float2 v = __ldcs(reinterpret_cast<const float2*>(cp));
            g[0] = v.x;
            g[1] = v.y;
            g[2] = __ldcs(cp + 2);
        } else {
            g[0] = __ldcs(cp);
            const float2 v = __ldcs(reinterpret_cast<const float2*>(cp + 1));
            g[1] = v.x;
            g[2] = v.y;
        }
        // taps 00, 01 in r0 and 10, 11 in r1, three floats each
        float r0[6], r1[6];
        if (o01 == o00 + 3) {  // then also o11 == o10 + 3: the same columns
            load_pair(img + o00, r0);
            load_pair(img + o10, r1);
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                r0[c] = __ldg(img + o00 + c);
                r0[3 + c] = __ldg(img + o01 + c);
                r1[c] = __ldg(img + o10 + c);
                r1[3 + c] = __ldg(img + o11 + c);
            }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float a00 = m00 ? r0[c] : 0.0f;
            const float a01 = m01 ? r0[3 + c] : 0.0f;
            const float a10 = m10 ? r1[c] : 0.0f;
            const float a11 = m11 ? r1[3 + c] : 0.0f;
            dgx = dgx + g[c] * ((1.0f - fy) * (a01 - a00) + fy * (a11 - a10));
            dgy = dgy + g[c] * ((1.0f - fx) * (a10 - a00) + fx * (a11 - a01));
        }
    } else {
        for (int c = 0; c < nc; ++c) {
            const float a00 = m00 ? __ldg(img + o00 + c) : 0.0f;
            const float a01 = m01 ? __ldg(img + o01 + c) : 0.0f;
            const float a10 = m10 ? __ldg(img + o10 + c) : 0.0f;
            const float a11 = m11 ? __ldg(img + o11 + c) : 0.0f;
            const float gc = __ldcs(cp + c);
            dgx = dgx + gc * ((1.0f - fy) * (a01 - a00) + fy * (a11 - a10));
            dgy = dgy + gc * ((1.0f - fx) * (a10 - a00) + fx * (a11 - a01));
        }
    }
    if (!zeros) {
        if (!(ux >= 0.0f && ux <= (float)(W - 1))) dgx = 0.0f;
        if (!(uy >= 0.0f && uy <= (float)(H - 1))) dgy = 0.0f;
    }
    const float sx = align_corners ? 0.5f * (float)(W - 1) : 0.5f * (float)W;
    const float sy = align_corners ? 0.5f * (float)(H - 1) : 0.5f * (float)H;
    // the output is fresh from torch.empty, so 8-byte aligned
    __stcs(reinterpret_cast<float2*>(out) + pixel, make_float2(dgx * sx, dgy * sy));
}

}  // namespace

// C interface.  Each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).  All three
// return cudaErrorInvalidValue (1) without launching unless an image
// frame indexes in 32 bits (H * W * C < 2^31 values), B <= 65535 and
// Ho <= 65535 * 8.

extern "C" int pwst_grid_sample_f32(const void* image, const void* grid, void* out,
                                    int B, int H, int W, int C, int Ho, int Wo,
                                    int zeros, int align_corners, void* stream) {
    if (!launch_fits(B, Ho, (long long)H * W * C)) return (int)cudaErrorInvalidValue;
    if (B > 0 && Ho > 0 && Wo > 0) {
        const dim3 blocks = launch_blocks(B, Ho, Wo, 1);
        const dim3 threads(kBlockX, kBlockY);
        if (C == 3) {
            grid_sample_f32_kernel<3><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const float*)image, (const float*)grid, (float*)out,
                H, W, C, Ho, Wo, zeros, align_corners);
        } else {
            grid_sample_f32_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const float*)image, (const float*)grid, (float*)out,
                H, W, C, Ho, Wo, zeros, align_corners);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int pwst_grid_sample_packed_u8(const void* image, const void* grid, void* out,
                                          int B, int H, int W, int Ho, int Wo,
                                          int align_corners, void* stream) {
    if (!launch_fits(B, Ho, (long long)H * W * 3)) return (int)cudaErrorInvalidValue;
    if (B > 0 && Ho > 0 && Wo > 0) {
        const dim3 blocks = launch_blocks(B, Ho, Wo, kPackedPixels);
        const dim3 threads(kBlockX, kBlockY);
        if (align_corners) {
            grid_sample_packed_u8_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const uint8_t*)image, (const float*)grid, (uint8_t*)out, H, W, Ho, Wo);
        } else {
            grid_sample_packed_u8_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const uint8_t*)image, (const float*)grid, (uint8_t*)out, H, W, Ho, Wo);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int pwst_grid_sample_grad_f32(const void* image, const void* grid,
                                         const void* cot, void* out,
                                         int B, int H, int W, int C, int Ho, int Wo,
                                         int zeros, int align_corners, void* stream) {
    if (!launch_fits(B, Ho, (long long)H * W * C)) return (int)cudaErrorInvalidValue;
    if (B > 0 && Ho > 0 && Wo > 0) {
        const dim3 blocks = launch_blocks(B, Ho, Wo, 1);
        const dim3 threads(kBlockX, kBlockY);
        if (C == 3) {
            grid_sample_grad_f32_kernel<3><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const float*)image, (const float*)grid, (const float*)cot, (float*)out,
                H, W, C, Ho, Wo, zeros, align_corners);
        } else {
            grid_sample_grad_f32_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const float*)image, (const float*)grid, (const float*)cot, (float*)out,
                H, W, C, Ho, Wo, zeros, align_corners);
        }
    }
    return (int)cudaGetLastError();
}
