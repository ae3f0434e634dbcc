// HBAO (horizon-based ambient occlusion) of the postprocess chain,
// hand-written for Hopper (sm_90a): the AO stage of a frame in four
// launches — the depth mips, the occlusion, and the depth-aware blur's
// horizontal and vertical passes.
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA
// (viamd_tpu/render/hbao.py: `_hbao_impl`, `_mip_stack`, `hbao_blur`).
// Ported op for op into eager PyTorch (render/hbao.py, the plain version
// this kernel is held to) it is ~1,100 launches over the frame: five
// full-resolution mip copies, 48 per-pixel gathers of the jitter tables, 16
// samples of ~60 ops each and a 12-tap blur, every op a pass over device
// memory, with the host issuing them one at a time.
//
// Inputs: the (H, W) linear view depth (+inf where empty; a value that is
// not finite reads as 1e8 everywhere, as the plain version's `_finite_or`),
// optionally (H, W, 3) view-space normals, and the frame's scalars, each
// the float32 value the plain version's op uses (render/cuda_hbao.py
// derives them). The 4×4 jitter tile's tables (per pixel phase (y & 3,
// x & 3): 16 samples' direction, weight and mip bias, and the weight sum)
// live in __constant__ memory, uploaded once per device.
//
//   hbao_mips_kernel   levels 1–4 of the depth pyramid, each at its own
//                      size ((h + 1) / 2 of the level below): the 2×2 mean
//                      of the level below, an odd last row or column
//                      replicated. A block reduces a 32×32 depth tile to
//                      16×16, 8×8, 4×4 and 2×2 texels in shared memory.
//                      The plain version's full-resolution stack reads
//                      level m at pixel (y, x) as texel (y >> m, x >> m).
//   hbao_ao_kernel     one thread a pixel: the view position, the normal
//                      (screen-space forward differences, clamped at the
//                      edge, unless given), the radius in pixels and the
//                      mip offset, then the 16 samples in the plain order —
//                      each a nearest fetch from its level's own array —
//                      accumulating max(N·V̂ − bias, 0)·falloff·weight, then
//                      the normalisation, the power and the far-plane test.
//   hbao_blur_kernel   one axis of the depth-aware separable blur (r = 1..3,
//                      each +r then −r, edge-clamped), launched for x then
//                      for y.
//
// Every expression is the plain version's, in its order, with float32
// operations as PyTorch's CUDA kernels compute them: the library is built
// with -fmad=false; a division by a Python number is a multiplication by
// its float32 reciprocal (PyTorch's CUDA division by a CPU scalar), a
// Python number divided by a tensor the tensor's reciprocal times the
// number (`Tensor.__rtruediv__`); log2f, exp2f, rsqrtf, powf and sqrtf as
// the ops call them; clamps propagate NaN; rintf rounds half to even as
// torch.round. Where PyTorch's own kernel contracts or orders its
// arithmetic (linalg.cross, vector_norm, the 2×2 mean), the kernel writes
// that order out. So the AO equals the plain version's on the card up to
// the last bits of the libdevice functions compiled without FMA
// contraction, and through them at pixels whose mip level
// round(mip_offset + bias) sits on a tie (tests/test_torch_hbao_kernel.py
// measures both).
//
// What bounds it on the H100: operations. Per pixel ~40 for the normal,
// 16 × ~35 for the samples and ~120 for the blur (~1.5 GFLOP at 1080p,
// 22 µs at 67 TFLOP/s); the bytes are the depth read once and the AO
// written once (16.6 MB, 5 µs). The samples' fetches are gathers into the
// depth and levels (8.3 + 2.8 MB, L2-resident), their latency hidden by
// the other warps of an SM. No full-resolution copy is written: the levels
// are 2.8 MB where the plain version's stack is 41.5 MB.

#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 16;   // AO_NUM_SAMPLES
constexpr int kPhases = 16;    // the 4×4 jitter tile
constexpr int kMips = 5;       // level 0 (the depth) and levels 1–4
constexpr int kTableFloats = kPhases * kSamples * 4 + kPhases;
constexpr int kBlockX = 32, kBlockY = 8;  // ao and blur: a warp a row of 32
constexpr int kMipTile = 16;              // mips: level-1 texels a block side
constexpr float kFill = 1e8f;             // render/hbao.py::_finite_or's fill

// (dx, dy, weight, mip bias) of sample i at phase (y & 3) * 4 + (x & 3),
// then each phase's weight sum: render/hbao.py::_jitter_tables
__constant__ float4 c_samples[kPhases * kSamples];
__constant__ float c_wsum[kPhases];

struct Levels {
  int w[kMips], h[kMips];  // level sizes; [0] is the frame
  int off[kMips];          // offsets of levels 1–4 in the scratch ([0] unused)
};

struct AoParams {
  int width, height, ortho, pow_mode;
  float inv_w, inv_h;  // f32(1 / f32(W)), f32(1 / f32(H))
  float du, dv;        // f32(1.0 / W), f32(1.0 / H): the normals' step
  float fw, fh;        // W, H
  float sx, sy, ox, oy;  // proj_info's uv → view constants
  float rts;           // radius_to_screen
  float rp_ortho;      // max(radius_to_screen, 3)
  float neg_inv_r2, bias, ao_mult, power, z_max;
};

struct BlurParams {
  int width, height;
  float sharpness, z_max;
  float c[3];  // f32(−r·r·fall), r = 1, 2, 3
};

// torch.clamp_min / torch.clamp on CUDA: NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float finite_or_fill(float v) {
  return isfinite(v) ? v : kFill;
}

Levels levels_of(int width, int height) {
  Levels l;
  l.w[0] = width;
  l.h[0] = height;
  l.off[0] = 0;
  int off = 0;
  for (int m = 1; m < kMips; ++m) {
    l.w[m] = (l.w[m - 1] + 1) / 2;
    l.h[m] = (l.h[m - 1] + 1) / 2;
    l.off[m] = off;
    off += l.w[m] * l.h[m];
  }
  return l;
}

int levels_floats(int width, int height) {
  const Levels l = levels_of(width, height);
  return l.off[kMips - 1] + l.w[kMips - 1] * l.h[kMips - 1];
}

// The 2×2 mean of `_mip_stack`, `reshape(h/2, 2, w/2, 2).mean(dim=(1, 3))`:
// PyTorch's CUDA reduction sums the four as (a00 + a10) + (a01 + a11) —
// four threads a texel, a shuffle tree — and scales by 0.25 (bit-equal on
// the card at every texel of 1080p frames).
__device__ __forceinline__ float mean4(float a00, float a01, float a10, float a11) {
  return ((a00 + a10) + (a01 + a11)) * 0.25f;
}

// Level m's texels of a block (side × side of them, side = kMipTile >> (m − 1))
// from its level m − 1 tile in shared memory (`src`, 2·side square): texel
// (i, j) averages rows 2i and min(2i + 1, h − 1) and columns likewise, h × w
// level m − 1's size. Writes them to the scratch and, given `dst`, to
// shared memory for the next level.
__device__ __forceinline__ void down(const float* src, int side, const Levels& lv, int m,
                                     float* dst, float* __restrict__ out) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (ty >= side || tx >= side) return;
  const int i = blockIdx.y * side + ty, j = blockIdx.x * side + tx;
  if (i >= lv.h[m] || j >= lv.w[m]) return;
  const int ps = 2 * side, r0 = blockIdx.y * ps, c0 = blockIdx.x * ps;
  const int ya = 2 * i - r0, yb = min(2 * i + 1, lv.h[m - 1] - 1) - r0;
  const int xa = 2 * j - c0, xb = min(2 * j + 1, lv.w[m - 1] - 1) - c0;
  const float v =
      mean4(src[ya * ps + xa], src[ya * ps + xb], src[yb * ps + xa], src[yb * ps + xb]);
  out[lv.off[m] + i * lv.w[m] + j] = v;
  if (dst) dst[ty * side + tx] = v;
}

__global__ void __launch_bounds__(kMipTile * kMipTile)
hbao_mips_kernel(const float* __restrict__ depth, Levels lv, float* __restrict__ out) {
  __shared__ float s1[kMipTile * kMipTile];
  __shared__ float s2[(kMipTile / 2) * (kMipTile / 2)];
  __shared__ float s3[(kMipTile / 4) * (kMipTile / 4)];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int W = lv.w[0], H = lv.h[0];
  // level 1: one texel a thread, from the depth (filled)
  const int i = blockIdx.y * kMipTile + ty, j = blockIdx.x * kMipTile + tx;
  float v = 0.0f;
  if (i < lv.h[1] && j < lv.w[1]) {
    const int ya = 2 * i, yb = min(2 * i + 1, H - 1);
    const int xa = 2 * j, xb = min(2 * j + 1, W - 1);
    v = mean4(finite_or_fill(__ldg(depth + ya * W + xa)),
              finite_or_fill(__ldg(depth + ya * W + xb)),
              finite_or_fill(__ldg(depth + yb * W + xa)),
              finite_or_fill(__ldg(depth + yb * W + xb)));
    out[lv.off[1] + i * lv.w[1] + j] = v;
  }
  s1[ty * kMipTile + tx] = v;
  // levels 2–4: every texel they read lies in the block's tile (an odd last
  // row or column of a level replicates itself)
  __syncthreads();
  down(s1, kMipTile / 2, lv, 2, s2, out);
  __syncthreads();
  down(s2, kMipTile / 4, lv, 3, s3, out);
  __syncthreads();
  down(s3, kMipTile / 8, lv, 4, nullptr, out);
}

// a[m] for a level m known only at run time, without indexing the
// parameter block dynamically
__device__ __forceinline__ int at_level(const int (&a)[kMips], int m) {
  int r = a[0];
#pragma unroll
  for (int k = 1; k < kMips; ++k) r = m == k ? a[k] : r;
  return r;
}

__device__ __forceinline__ float view_x(const AoParams& p, float u, float z) {
  const float x = u * p.sx + p.ox;
  return p.ortho ? x : x * z;
}
__device__ __forceinline__ float view_y(const AoParams& p, float v, float z) {
  const float y = v * p.sy + p.oy;
  return p.ortho ? y : y * z;
}

// a·b − c·d as PyTorch's linalg.cross kernel computes it on the card
// (compiled with FMA contraction): fma(a, b, −(c·d)), bit-equal on the card
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ float ao_power(float a, int mode, float e) {
  switch (mode) {  // torch.pow(t, e)'s special cases, then powf
    case 0: return 1.0f;
    case 1: return a;
    case 2: return a * a;
    case 3: return a * a * a;
    case 4: return sqrtf(a);
    default: return powf(a, e);
  }
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
hbao_ao_kernel(const float* __restrict__ depth, const float* __restrict__ normals,
               const float* __restrict__ levels, Levels lv, AoParams p,
               float* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int W = p.width, H = p.height;
  if (x >= W || y >= H) return;
  const int idx = y * W + x;
  const float d = finite_or_fill(__ldg(depth + idx));
  const float u = ((float)x + 0.5f) * p.inv_w;
  const float v = ((float)y + 0.5f) * p.inv_h;
  const float Px = view_x(p, u, d), Py = view_y(p, v, d), Pz = d;

  float Nx, Ny, Nz;
  if (normals) {
    Nx = __ldg(normals + 3 * idx);
    Ny = __ldg(normals + 3 * idx + 1);
    Nz = __ldg(normals + 3 * idx + 2);
  } else {  // view_normals: −cross(px − p0, py − p0), normalised
    const float dE = finite_or_fill(__ldg(depth + y * W + min(x + 1, W - 1)));
    const float dS = finite_or_fill(__ldg(depth + min(y + 1, H - 1) * W + x));
    const float ue = u + p.du, vs = v + p.dv;
    const float ax = view_x(p, ue, dE) - Px, ay = view_y(p, v, dE) - Py, az = dE - Pz;
    const float bx = view_x(p, u, dS) - Px, by = view_y(p, vs, dS) - Py, bz = dS - Pz;
    const float nx = -cross_term(ay, bz, az, by);
    const float ny = -cross_term(az, bx, ax, bz);
    const float nz = -cross_term(ax, by, ay, bx);
    // vector_norm over the last axis of 3: two threads an output, the first
    // summing elements 0 and 2, a shuffle adding element 1
    const float nn = clamp_min_nan(sqrtf((nx * nx + nz * nz) + ny * ny), 1e-12f);
    Nx = nx / nn;
    Ny = ny / nn;
    Nz = nz / nn;
  }

  const float rp = p.ortho ? p.rp_ortho : clamp_min_nan((1.0f / d) * p.rts, 3.0f);
  const float mip_offset = log2f(rp * 4.0f) + -4.3f;
  const int phase = ((y & 3) << 2) | (x & 3);
  float ao = 0.0f;
#pragma unroll 4
  for (int i = 0; i < kSamples; ++i) {
    const float4 s = c_samples[phase * kSamples + i];
    const float su = u + (s.x * rp) * p.inv_w;
    const float sv = v + (s.y * rp) * p.inv_h;
    const int m = (int)clamp_nan(rintf(mip_offset + s.w), 0.0f, (float)(kMips - 1));
    const int xi = min(max((int)(su * p.fw), 0), W - 1);
    const int yi = min(max((int)(sv * p.fh), 0), H - 1);
    const float sz = m == 0
        ? finite_or_fill(__ldg(depth + yi * W + xi))
        : __ldg(levels + at_level(lv.off, m) + (yi >> m) * at_level(lv.w, m) + (xi >> m));
    const float Vx = view_x(p, su, sz) - Px;
    const float Vy = view_y(p, sv, sz) - Py;
    const float Vz = sz - Pz;
    const float vdotv = Vx * Vx + Vy * Vy + Vz * Vz;
    const float ndotv = (Nx * Vx + Ny * Vy + Nz * Vz) * rsqrtf(clamp_min_nan(vdotv, 1e-12f));
    const float falloff = clamp_min_nan(vdotv * p.neg_inv_r2 + 1.0f, 0.0f);
    ao = ao + clamp_min_nan(ndotv - p.bias, 0.0f) * falloff * s.z;
  }
  float a = clamp_nan(1.0f - ao * ((1.0f / c_wsum[phase]) * p.ao_mult), 0.0f, 1.0f);
  a = ao_power(a, p.pow_mode, p.power);
  out[idx] = d > p.z_max ? 1.0f : a;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
hbao_blur_kernel(const float* __restrict__ src, const float* __restrict__ depth,
                 BlurParams p, int axis, float* __restrict__ out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int W = p.width, H = p.height;
  if (x >= W || y >= H) return;
  const int idx = y * W + x;
  const float d = finite_or_fill(__ldg(depth + idx));
  const float c = __ldg(src + idx);
  const int pos = axis ? y : x, n = axis ? H : W;
  float total = c, wtot = 1.0f;
#pragma unroll
  for (int r = 1; r <= 3; ++r) {
#pragma unroll
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int q = min(max(pos + sgn * r, 0), n - 1);
      const int j = axis ? q * W + x : y * W + q;
      const float ddiff = (finite_or_fill(__ldg(depth + j)) - d) * p.sharpness;
      const float w = exp2f(p.c[r - 1] - ddiff * ddiff);
      total = total + __ldg(src + j) * w;
      wtot = wtot + w;
    }
  }
  out[idx] = d > p.z_max ? c : total / wtot;
}

dim3 pixel_blocks(int width, int height) {
  return dim3((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" int hbao_table_floats() { return kTableFloats; }

// Copies the table image (kTableFloats host floats: c_samples then c_wsum)
// into the current device's __constant__ memory and waits for the copy.
extern "C" int hbao_set_tables(const float* image, int n) {
  if (n != kTableFloats) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(c_samples, image, sizeof(float4) * kPhases * kSamples);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_wsum, image + kPhases * kSamples * 4, sizeof(float) * kPhases);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

// Launches the mips on `stream`: levels 1–4 of the (height, width) depth
// into `levels` (n_levels floats, hbao_levels_floats of the frame).
extern "C" int hbao_mips_launch(const float* depth, int width, int height, float* levels,
                                int n_levels, void* stream) {
  if (width <= 0 || height <= 0 || n_levels != levels_floats(width, height))
    return (int)cudaErrorInvalidValue;
  const Levels lv = levels_of(width, height);
  const dim3 blocks((lv.w[1] + kMipTile - 1) / kMipTile, (lv.h[1] + kMipTile - 1) / kMipTile);
  hbao_mips_kernel<<<blocks, dim3(kMipTile, kMipTile), 0, (cudaStream_t)stream>>>(
      depth, lv, levels);
  return (int)cudaGetLastError();
}

// Launches the occlusion on `stream`. `scal` is a host array of 17 floats
// (inv_w inv_h du dv sx sy ox oy rts rp_ortho neg_inv_r2 bias ao_mult
// power z_max, and W, H as floats); `normals` may be null.
extern "C" int hbao_ao_launch(const float* depth, const float* normals, const float* levels,
                              int n_levels, int width, int height, int ortho, int pow_mode,
                              const float* scal, float* ao, void* stream) {
  if (width <= 0 || height <= 0 || n_levels != levels_floats(width, height))
    return (int)cudaErrorInvalidValue;
  AoParams p;
  p.width = width;
  p.height = height;
  p.ortho = ortho;
  p.pow_mode = pow_mode;
  float* const fields[17] = {&p.inv_w, &p.inv_h, &p.du, &p.dv, &p.sx, &p.sy,
                             &p.ox, &p.oy, &p.rts, &p.rp_ortho, &p.neg_inv_r2, &p.bias,
                             &p.ao_mult, &p.power, &p.z_max, &p.fw, &p.fh};
  for (int j = 0; j < 17; ++j) *fields[j] = scal[j];
  hbao_ao_kernel<<<pixel_blocks(width, height), dim3(kBlockX, kBlockY), 0,
                   (cudaStream_t)stream>>>(depth, normals, levels, levels_of(width, height), p,
                                           ao);
  return (int)cudaGetLastError();
}

// Launches one blur pass on `stream` (axis 0: along x, 1: along y). `scal`
// is a host array of 5 floats (sharpness z_max c1 c2 c3).
extern "C" int hbao_blur_launch(const float* src, const float* depth, int width, int height,
                                int axis, const float* scal, float* out, void* stream) {
  if (width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  BlurParams p;
  p.width = width;
  p.height = height;
  p.sharpness = scal[0];
  p.z_max = scal[1];
  for (int j = 0; j < 3; ++j) p.c[j] = scal[2 + j];
  hbao_blur_kernel<<<pixel_blocks(width, height), dim3(kBlockX, kBlockY), 0,
                     (cudaStream_t)stream>>>(src, depth, p, axis, out);
  return (int)cudaGetLastError();
}
