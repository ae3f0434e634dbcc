// Volume ray-march (DVR + isosurfaces) for the volume renderer, hand-written
// for Hopper (sm_90a): one thread per pixel, the whole march in registers.
//
// Replaces no Pallas kernel: the JAX package marches in one jitted XLA
// program, the fori_loop of viamd_tpu/render/volume.py:263-316 (the `step`
// loop) and the background compose (:318-320), which XLA fuses. Ported op
// for op into eager PyTorch the same march launches ~70 kernels per
// trilinear sample, ~450 per isosurface crossing test, for every one of
// its max(dims)·samples_per_voxel steps over the whole frame
// (render/cuda_volume.py::march_plain, the plain version this kernel is
// held to).
//
// Inputs: the per-ray table of render/volume.py::ray_setup, (15, P) float32
// planes (ox oy oz dx dy dz t0 t1 dt tex_dt vx vy vz jit hit), so
// neighbouring threads read neighbouring words; the (D0, D1, D2) grid, the
// (N, 4) transfer function and the optional (D0', D1', D2', 3) colour
// volume, all read through __ldg; the scalars and up to kMaxIso iso values
// and colours in the parameter block. Outputs: rgba (H, W, 4) and depth
// (H, W), +inf where nothing is hit.
//
// Per ray, step k (k = 0 … nsteps − 1) is live while alpha < 0.995 and
// k·dt + t0 < t1. It samples the grid trilinearly at t = t0 + (k + jit)·dt,
// composites every isosurface crossed since the last sample (k > 0, in iso
// order: linear refinement with the 0.5 fallback, central-difference
// normal, |n·l| Phong shading), then the transfer function's colour (or the
// colour volume's) with opacity 1 − max(1 − a, 1e-7)^(tex_dt·150); depth is
// the first iso hit's t or the t where alpha first passes 0.5. A step that
// is not live leaves everything unchanged and no later step is live again
// (alpha never falls, k·dt + t0 never shrinks), so the loop breaks there:
// the early exit gives the masked loop's result.
//
// Every expression is the plain version's, in its order, with correctly
// rounded float32 operations (the library is built with -fmad=false; sqrtf,
// division and powf as torch's CUDA ops compute them), so the kernel agrees
// with march_plain on the same table except where powf and torch.pow round
// apart.
//
// What bounds it on the H100: the live samples, each 8 dependent gathers
// from a grid that fits in L2 (128³ f32 = 8 MiB) plus ~90 float32
// operations, and ~330 more per iso crossing (6 samples for the gradient).
// chip_smoke.py counts both from the plain version and prints the bound
// (operations over 67 TFLOP/s f32, or the table, grid and outputs over
// 3.35 TB/s). The design keeps the march's state in registers and stops a
// ray at its last live step; later work: shared-memory bricks or a 3D
// texture for the gathers, an empty-space skip, and warps that lose rays
// early (most of a warp's lanes idle once its rays terminate unevenly).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIso = 8;
constexpr int kRays = 15;
constexpr int kThreads = 128;

enum Ray { OX, OY, OZ, DX, DY, DZ, T0, T1, DT, TEXDT, VX, VY, VZ, JIT, HIT };

struct Params {
  int n0, n1, n2;  // grid dims
  int ntf;         // transfer-function entries
  int c0, c1, c2;  // colour-volume dims
  int npix, nsteps, enable_dvr, use_cvol, n_iso;
  float vmin, vspan, lx, ly, lz, ambient, one_m_amb, specular, shininess, h;
  float bg_r, bg_g, bg_b, bg_a;
  float iso_v[kMaxIso];
  float iso_c[kMaxIso][4];
};

struct Corners {
  int i0[3], i1[3];
  float w0[3], w1[3];  // 1 − f, f per axis
};

// the trilinear corners of texture point p in an (n0, n1, n2) grid,
// clamp-to-edge (cuda_volume.py::_corners)
__device__ __forceinline__ Corners corners(int n0, int n1, int n2, float px,
                                           float py, float pz) {
  Corners c;
  const float p[3] = {px, py, pz};
  const int n[3] = {n0, n1, n2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = p[a] * (float)n[a] - 0.5f;
    const float g0 = floorf(g);
    const float f = g - g0;
    const int i = (int)g0;
    c.i0[a] = min(max(i, 0), n[a] - 1);
    c.i1[a] = min(max(i + 1, 0), n[a] - 1);
    c.w0[a] = 1.0f - f;
    c.w1[a] = f;
  }
  return c;
}

__device__ __forceinline__ float sample(const float* __restrict__ g, int n0,
                                        int n1, int n2, float px, float py,
                                        float pz) {
  const Corners c = corners(n0, n1, n2, px, py, pz);
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
    const int ix = ox ? c.i1[0] : c.i0[0];
    const int iy = oy ? c.i1[1] : c.i0[1];
    const int iz = oz ? c.i1[2] : c.i0[2];
    const float wt = (ox ? c.w1[0] : c.w0[0]) * (oy ? c.w1[1] : c.w0[1]) *
                     (oz ? c.w1[2] : c.w0[2]);
    out = out + wt * __ldg(g + (ix * n1 + iy) * n2 + iz);
  }
  return out;
}

__device__ __forceinline__ void sample3(const float* __restrict__ g, int n0,
                                        int n1, int n2, float px, float py,
                                        float pz, float* out) {
  const Corners c = corners(n0, n1, n2, px, py, pz);
  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
    const int ix = ox ? c.i1[0] : c.i0[0];
    const int iy = oy ? c.i1[1] : c.i0[1];
    const int iz = oz ? c.i1[2] : c.i0[2];
    const float wt = (ox ? c.w1[0] : c.w0[0]) * (oy ? c.w1[1] : c.w0[1]) *
                     (oz ? c.w1[2] : c.w0[2]);
    const float* v = g + ((ix * n1 + iy) * n2 + iz) * 3;
    out[0] = out[0] + wt * __ldg(v);
    out[1] = out[1] + wt * __ldg(v + 1);
    out[2] = out[2] + wt * __ldg(v + 2);
  }
}

__global__ void __launch_bounds__(kThreads) volume_kernel(
    const float* __restrict__ grid, const float* __restrict__ tf,
    const float* __restrict__ cvol, const float* __restrict__ rays,
    const Params p, float4* __restrict__ rgba, float* __restrict__ depth_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.npix) return;
  const float* r = rays + i;
  const int P = p.npix;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, alpha = 0.0f, depth = 1e30f;
  if (__ldg(r + HIT * P) > 0.0f) {
    const float ox = __ldg(r + OX * P), oy = __ldg(r + OY * P),
                oz = __ldg(r + OZ * P);
    const float dx = __ldg(r + DX * P), dy = __ldg(r + DY * P),
                dz = __ldg(r + DZ * P);
    const float t0 = __ldg(r + T0 * P), t1 = __ldg(r + T1 * P);
    const float dt = __ldg(r + DT * P), tex_dt = __ldg(r + TEXDT * P);
    const float jit = __ldg(r + JIT * P);
    // the half vector (light + view direction), the same at every step
    float hx = p.lx + __ldg(r + VX * P), hy = p.ly + __ldg(r + VY * P),
          hz = p.lz + __ldg(r + VZ * P);
    const float hn = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-12f);
    hx = hx / hn;
    hy = hy / hn;
    hz = hz / hn;
    const float expo = tex_dt * 150.0f;
    float prev_s = 0.0f;
    for (int k = 0; k < p.nsteps; ++k) {
      const float kf = (float)k;
      if (!(alpha < 0.995f) || !(kf * dt + t0 < t1)) break;  // not live
      const float t = t0 + (kf + jit) * dt;
      const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
      const float s = sample(grid, p.n0, p.n1, p.n2, px, py, pz);
      float trans = 1.0f - alpha;
      if (k > 0) {
        for (int j = 0; j < p.n_iso; ++j) {
          const float vi = p.iso_v[j];
          if (!((prev_s - vi) * (s - vi) < 0.0f)) continue;
          const float ds = s - prev_s;
          const float frac = fabsf(ds) > 1e-12f ? (vi - prev_s) / ds : 0.5f;
          const float t_hit =
              t0 + (((kf - 1.0f) + jit) + fminf(fmaxf(frac, 0.0f), 1.0f)) * dt;
          const float qx = ox + dx * t_hit, qy = oy + dy * t_hit,
                      qz = oz + dz * t_hit;
          const float gx = sample(grid, p.n0, p.n1, p.n2, qx + p.h, qy, qz) -
                           sample(grid, p.n0, p.n1, p.n2, qx - p.h, qy, qz);
          const float gy = sample(grid, p.n0, p.n1, p.n2, qx, qy + p.h, qz) -
                           sample(grid, p.n0, p.n1, p.n2, qx, qy - p.h, qz);
          const float gz = sample(grid, p.n0, p.n1, p.n2, qx, qy, qz + p.h) -
                           sample(grid, p.n0, p.n1, p.n2, qx, qy, qz - p.h);
          const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
          const float nx = gx / gn, ny = gy / gn, nz = gz / gn;
          const float ndl = fabsf(nx * p.lx + ny * p.ly + nz * p.lz);
          const float ndh = fabsf(nx * hx + ny * hy + nz * hz);
          const float spec = p.specular * powf(ndh, p.shininess);
          const float lum = p.ambient + p.one_m_amb * ndl;
          const float contrib = trans * p.iso_c[j][3];
          c0 = c0 + (p.iso_c[j][0] * lum + spec) * contrib;
          c1 = c1 + (p.iso_c[j][1] * lum + spec) * contrib;
          c2 = c2 + (p.iso_c[j][2] * lum + spec) * contrib;
          alpha = alpha + contrib;
          if (depth >= 1e30f) depth = t_hit;
          trans = 1.0f - alpha;
        }
      }
      if (p.enable_dvr) {
        // transfer function at (s − vmin) / vspan, clamped to [0, 1]
        const float x =
            fminf(fmaxf((s - p.vmin) / p.vspan, 0.0f), 1.0f) * (float)(p.ntf - 1);
        const int i0 = min(max((int)floorf(x), 0), p.ntf - 1);
        const int i1 = min(max(i0 + 1, 0), p.ntf - 1);
        const float f = x - (float)i0;
        const float g = 1.0f - f;
        const float4 a = __ldg(reinterpret_cast<const float4*>(tf) + i0);
        const float4 b = __ldg(reinterpret_cast<const float4*>(tf) + i1);
        const float ca = a.w * g + b.w * f;
        const float a_corr = 1.0f - powf(fmaxf(1.0f - ca, 1e-7f), expo);
        const float a_eff = trans * a_corr;
        float base[3];
        if (p.use_cvol) {
          sample3(cvol, p.c0, p.c1, p.c2, px, py, pz, base);
        } else {
          base[0] = a.x * g + b.x * f;
          base[1] = a.y * g + b.y * f;
          base[2] = a.z * g + b.z * f;
        }
        c0 = c0 + base[0] * a_eff;
        c1 = c1 + base[1] * a_eff;
        c2 = c2 + base[2] * a_eff;
        alpha = alpha + a_eff;
        if (alpha > 0.5f && depth >= 1e30f) depth = t;
      }
      prev_s = s;
    }
  }
  const float one_m_a = 1.0f - alpha;
  rgba[i] = make_float4(c0 + p.bg_r * one_m_a * p.bg_a,
                        c1 + p.bg_g * one_m_a * p.bg_a,
                        c2 + p.bg_b * one_m_a * p.bg_a, alpha);
  depth_out[i] = depth >= 1e30f ? __int_as_float(0x7f800000) : depth;  // +inf
}

}  // namespace

extern "C" int volume_max_iso() { return kMaxIso; }
extern "C" int volume_num_rays() { return kRays; }

// Launches one thread per pixel on `stream`. `scal` is a host array of
// 14 floats (vmin vspan lx ly lz ambient one_m_amb specular shininess
// h bg_r bg_g bg_b bg_a), `iso` n_iso groups of (value, r, g, b, a).
// Returns cudaGetLastError() right after the launch (1 = cudaErrorInvalidValue
// for n_iso beyond kMaxIso).
extern "C" int volume_launch(const float* grid, int n0, int n1, int n2,
                             const float* tf, int ntf, const float* cvol,
                             int c0, int c1, int c2, const float* rays,
                             int npix, int nsteps, int enable_dvr,
                             int use_cvol, int n_iso, const float* scal,
                             const float* iso, float* rgba, float* depth,
                             void* stream) {
  if (n_iso < 0 || n_iso > kMaxIso) return (int)cudaErrorInvalidValue;
  Params p;
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  p.ntf = ntf;
  p.c0 = c0;
  p.c1 = c1;
  p.c2 = c2;
  p.npix = npix;
  p.nsteps = nsteps;
  p.enable_dvr = enable_dvr;
  p.use_cvol = use_cvol;
  p.n_iso = n_iso;
  p.vmin = scal[0];
  p.vspan = scal[1];
  p.lx = scal[2];
  p.ly = scal[3];
  p.lz = scal[4];
  p.ambient = scal[5];
  p.one_m_amb = scal[6];
  p.specular = scal[7];
  p.shininess = scal[8];
  p.h = scal[9];
  p.bg_r = scal[10];
  p.bg_g = scal[11];
  p.bg_b = scal[12];
  p.bg_a = scal[13];
  for (int j = 0; j < kMaxIso; ++j) {
    const bool on = j < n_iso;
    p.iso_v[j] = on ? iso[j * 5] : 0.0f;
    for (int c = 0; c < 4; ++c) p.iso_c[j][c] = on ? iso[j * 5 + 1 + c] : 0.0f;
  }
  if (npix > 0) {
    volume_kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(grid, tf, cvol, rays, p,
                                            (float4*)rgba, depth);
  }
  return (int)cudaGetLastError();
}
