// Volume frame (ray setup + DVR + isosurfaces) for the volume renderer,
// hand-written for Hopper (sm_90a): one launch computes the whole frame
// from the camera, the grid and the jitter.
//
// Replaces no Pallas kernel: the JAX package marches in one jitted XLA
// program, the fori_loop of viamd_tpu/render/volume.py:263-316 (the `step`
// loop) and the background compose (:318-320), which XLA fuses with the
// ray setup before it (:176-227). Ported op for op into eager PyTorch the
// setup is ~60 ops over the frame and the march ~70 launches per
// trilinear sample for every one of its max(dims)·samples_per_voxel steps
// (render/cuda_volume.py::ray_setup + march_plain, the plain version this
// kernel is held to).
//
// Inputs: the parameter block (the inverses of proj·view and of the model
// matrix, row 2 of the view matrix, the clip box, the frame size, the
// march's scalars and up to kMaxIso iso values and colours); the (P,)
// jitter and the (H, W) scene depth, each optional; the grid, the (N, 4)
// transfer function and the optional colour volume, read through __ldg,
// the volumes row-major. Outputs: rgba (H, W, 4) and depth (H, W), +inf
// where nothing is hit; and, when `rays_out` is not null, the (15, P) ray
// table of ray_setup (ox oy oz dx dy dz t0 t1 dt tex_dt vx vy vz jit hit)
// so that a check can hold the setup to its plain version word for word.
//
// Each thread builds its own ray: pixel (x, y) at NDC ((x + 0.5)/W·2 − 1,
// (y + 0.5)/H·2 − 1), unprojected at NDC z = −1 and 0 (the far plane
// degenerates) through inv(proj·view) and inv(model) into texture space,
// entry and exit of the clip box, the exit clamped where the ray passes the
// scene depth (view depth is affine in t), the step dt = (t1 − t0)/nsteps
// and the unit view direction, all in ray_setup's order. Then step k
// (k = 0 … nsteps − 1) is live while alpha < 0.995 and k·dt + t0 < t1. It
// samples the grid trilinearly at t = t0 + (k + jit)·dt, composites every
// isosurface crossed since the last sample (k > 0, in iso order: linear
// refinement with the 0.5 fallback, central-difference normal, |n·l| Phong
// shading), then the transfer function's colour (or the colour volume's)
// with opacity 1 − max(1 − a, 1e-7)^(tex_dt·150); depth is the first iso
// hit's t or the t where alpha first passes 0.5. A step that is not live
// leaves everything unchanged and no later step is live again (alpha never
// falls, k·dt + t0 never shrinks), so the loop breaks there: the early exit
// gives the masked loop's result.
//
// Every expression is the plain version's, in its order, with correctly
// rounded float32 operations (the library is built with -fmad=false;
// division, reciprocal and sqrt as __fdiv_rn, __frcp_rn, __fsqrt_rn or
// IEEE `/` and sqrtf, which is how torch's CUDA ops compute them; min and
// max propagate NaN as torch.minimum and torch.maximum do), so the ray
// table equals ray_setup's on the card bit for bit, and the frame agrees
// with march_plain except where powf and torch.pow round apart.
//
// What bounds it on the H100: the live samples, each 8 gathers from a grid
// that fits in L2 (128³ f32 = 8 MiB) plus ~96 float32 operations (a
// correctly rounded division and a powf among them), ~350 more per iso
// crossing (6 samples for the gradient), and the setup's ~180 operations
// a pixel; the bytes are the grid, the tables and the outputs
// (chip_smoke.py prints the bound). Issue slots and the latency of the
// gathers, not bytes, set its time. The design against that: no ray
// table in device memory (the setup is in registers); a warp marches an
// 8×4 tile of pixels, so its lanes enter, leave and terminate at nearly
// the same steps and sample neighbouring voxels; step k + 1's 8 loads are
// issued before step k composites (its position depends only on the ray
// and k; loads have no side effects and are used only if step k + 1 is
// live), so their latency hides behind the compositing; and
// __launch_bounds__ holds a thread to 80 registers (6 blocks, 24 warps an
// SM) without spills, where the compiler left alone takes ~160 (3 blocks).
// The grid stays row-major: bricks of 2³–8³, timed on the card, were
// 21–27% slower (their index arithmetic costs more issue slots than their
// locality saves, and spilled at 80 registers; PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxIso = 8;
constexpr int kRays = 15;
constexpr int kTileW = 8, kTileH = 4;       // a warp's pixel tile
constexpr int kWarpsX = 2, kWarpsY = 2;     // a block's tiles
constexpr int kThreads = 32 * kWarpsX * kWarpsY;
constexpr int kMinBlocks = 6;               // __launch_bounds__' blocks an SM
constexpr int kBlockW = kTileW * kWarpsX, kBlockH = kTileH * kWarpsY;

enum Ray { OX, OY, OZ, DX, DY, DZ, T0, T1, DT, TEXDT, VX, VY, VZ, JIT, HIT };

struct Params {
  int n0, n1, n2;     // grid dims
  int ntf;            // transfer-function entries
  int c0, c1, c2;     // colour-volume dims
  int width, height, nsteps, enable_dvr, use_cvol, n_iso;
  float vmin, vspan, lx, ly, lz, ambient, one_m_amb, specular, shininess, h;
  float bg_r, bg_g, bg_b, bg_a;
  float inv_vp[16], inv_model[16];  // row-major float32 inverses
  float view_z[4];                  // row 2 of the view matrix
  float lo[3], hi[3];               // the clip box, texture space
  float iso_v[kMaxIso];
  float iso_c[kMaxIso][4];
};

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum on CUDA: NaN if either is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? quiet_nan() : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? quiet_nan() : fmaxf(a, b);
}
// torch.clamp_min(v, lo) on CUDA: NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

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

// A sample's 8 corner values and its fractions f per axis (the weights
// are 1 − f and f), loaded ahead of their use.
struct Fetch {
  float f[3];
  float v[8];
};

// step k's sample point t = t0 + (k + jit)·dt on the ray o + t·d
__device__ __forceinline__ Fetch fetch(const float* __restrict__ g, const Params& p,
                                       float ox, float oy, float oz, float dx,
                                       float dy, float dz, float t0, float jit,
                                       float dt, int k) {
  const float t = t0 + ((float)k + jit) * dt;
  const Corners c = corners(p.n0, p.n1, p.n2, ox + dx * t, oy + dy * t, oz + dz * t);
  Fetch f;
#pragma unroll
  for (int a = 0; a < 3; ++a) f.f[a] = c.w1[a];
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const int bx = (k8 >> 2) & 1, by = (k8 >> 1) & 1, bz = k8 & 1;
    const int ix = bx ? c.i1[0] : c.i0[0], iy = by ? c.i1[1] : c.i0[1];
    // one 32-bit offset, then one pointer add: `g + a + b` adds to the
    // 64-bit pointer twice, which cost ~7% of the kernel's time on the H100
    f.v[k8] = __ldg(g + ((ix * p.n1 + iy) * p.n2 + (bz ? c.i1[2] : c.i0[2])));
  }
  return f;
}

// the trilinear sum of a fetch, in the corner order and with the weights
// of `sample` (1 − f as `corners` rounds it)
__device__ __forceinline__ float blend(const Fetch& f) {
  float w0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) w0[a] = 1.0f - f.f[a];
  float out = 0.0f;
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const int bx = (k8 >> 2) & 1, by = (k8 >> 1) & 1, bz = k8 & 1;
    const float wt = (bx ? f.f[0] : w0[0]) * (by ? f.f[1] : w0[1]) * (bz ? f.f[2] : w0[2]);
    out = out + wt * f.v[k8];
  }
  return out;
}

__device__ __forceinline__ float sample(const float* __restrict__ g, const Params& p,
                                        float px, float py, float pz) {
  const Corners c = corners(p.n0, p.n1, p.n2, px, py, pz);
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
    const int ix = ox ? c.i1[0] : c.i0[0];
    const int iy = oy ? c.i1[1] : c.i0[1];
    const int iz = oz ? c.i1[2] : c.i0[2];
    const float wt = (ox ? c.w1[0] : c.w0[0]) * (oy ? c.w1[1] : c.w0[1]) *
                     (oz ? c.w1[2] : c.w0[2]);
    out = out + wt * __ldg(g + ((ix * p.n1 + iy) * p.n2 + iz));
  }
  return out;
}

__device__ __forceinline__ void sample3(const float* __restrict__ g, const Params& p,
                                        float px, float py, float pz, float* out) {
  const Corners c = corners(p.c0, p.c1, p.c2, px, py, pz);
  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
    const int ix = ox ? c.i1[0] : c.i0[0];
    const int iy = oy ? c.i1[1] : c.i0[1];
    const int iz = oz ? c.i1[2] : c.i0[2];
    const float wt = (ox ? c.w1[0] : c.w0[0]) * (oy ? c.w1[1] : c.w0[1]) *
                     (oz ? c.w1[2] : c.w0[2]);
    const float* v = g + ((ix * p.c1 + iy) * p.c2 + iz) * 3;
    out[0] = out[0] + wt * __ldg(v);
    out[1] = out[1] + wt * __ldg(v + 1);
    out[2] = out[2] + wt * __ldg(v + 2);
  }
}

// homogeneous transform of (x, y, z, 1) by the row-major 4x4 m, with the
// guard of the perspective divide (|w'| < 1e-12 → ±1e-12; _apply44)
__device__ __forceinline__ void apply44(const float* m, float x, float y, float z,
                                        float* out) {
  float o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    o[r] = x * m[4 * r] + y * m[4 * r + 1] + z * m[4 * r + 2] + m[4 * r + 3];
  }
  float w = o[3];
  if (fabsf(w) < 1e-12f) w = w < 0.0f ? -1e-12f : 1e-12f;
  out[0] = __fdiv_rn(o[0], w);
  out[1] = __fdiv_rn(o[1], w);
  out[2] = __fdiv_rn(o[2], w);
}

// view depth −z_view of a world point (ray_setup's vdepth)
__device__ __forceinline__ float view_depth(const Params& p, const float* q) {
  return -(q[0] * p.view_z[0] + q[1] * p.view_z[1] + q[2] * p.view_z[2] + p.view_z[3]);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) volume_kernel(
    const float* __restrict__ grid, const float* __restrict__ tf,
    const float* __restrict__ cvol, const float* __restrict__ jitter,
    const float* __restrict__ scene_depth, const Params p,
    float4* __restrict__ rgba, float* __restrict__ depth_out,
    float* __restrict__ rays_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = blockIdx.x * kBlockW + (warp % kWarpsX) * kTileW + lane % kTileW;
  const int y = blockIdx.y * kBlockH + (warp / kWarpsX) * kTileH + lane / kTileW;
  if (x >= p.width || y >= p.height) return;
  const int i = y * p.width + x;

  // -- the ray (render/cuda_volume.py::ray_setup, in its order) -------------
  const float ndc_x = __fdiv_rn((float)x + 0.5f, (float)p.width) * 2.0f - 1.0f;
  const float ndc_y = __fdiv_rn((float)y + 0.5f, (float)p.height) * 2.0f - 1.0f;
  float w_near[3], w_far[3], o[3], e[3];
  apply44(p.inv_vp, ndc_x, ndc_y, -1.0f, w_near);
  apply44(p.inv_vp, ndc_x, ndc_y, 0.0f, w_far);
  apply44(p.inv_model, w_near[0], w_near[1], w_near[2], o);
  apply44(p.inv_model, w_far[0], w_far[1], w_far[2], e);
  const float dx = e[0] - o[0], dy = e[1] - o[1], dz = e[2] - o[2];
  const float d[3] = {dx, dy, dz};
  float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // ray_box
    const float da = fabsf(d[a]) < 1e-12f ? 1e-12f : d[a];
    const float inv = __frcp_rn(da);
    const float ta = (p.lo[a] - o[a]) * inv, tb = (p.hi[a] - o[a]) * inv;
    const float near = min_nan(ta, tb), far = max_nan(ta, tb);
    t0 = a ? max_nan(t0, near) : near;
    t1 = a ? min_nan(t1, far) : far;
  }
  t0 = clamp_min_nan(t0, 0.0f);
  if (scene_depth != nullptr) {
    const float zd0 = view_depth(p, w_near);
    float zdb = view_depth(p, w_far) - zd0;
    if (fabsf(zdb) < 1e-12f) zdb = 1e-12f;
    const float zs = __ldg(scene_depth + i);
    const float t_scene = __fdiv_rn(zs - zd0, zdb);
    t1 = min_nan(t1, isfinite(zs) ? t_scene : t1);
  }
  const bool hit = t1 > t0;
  const float dt = hit ? __fdiv_rn(t1 - t0, (float)p.nsteps) : 0.0f;
  const float dnorm = __fsqrt_rn(dx * dx + dy * dy + dz * dz);
  const float tex_dt = dt * dnorm;
  const float vn = clamp_min_nan(dnorm, 1e-12f);
  const float vx = __fdiv_rn(-dx, vn), vy = __fdiv_rn(-dy, vn), vz = __fdiv_rn(-dz, vn);
  const float jit = jitter != nullptr ? __ldg(jitter + i) : 0.0f;
  if (rays_out != nullptr) {
    const int P = p.width * p.height;
    const float row[kRays] = {o[0], o[1], o[2], dx,  dy, dz,  t0,  t1,
                              dt,   tex_dt, vx, vy, vz, jit, hit ? 1.0f : 0.0f};
#pragma unroll
    for (int r = 0; r < kRays; ++r) rays_out[r * P + i] = row[r];
  }

  // -- the march ---------------------------------------------------------------
  const float ox = o[0], oy = o[1], oz = o[2];
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, alpha = 0.0f, depth = 1e30f;
  if (hit) {
    // the half vector (light + view direction), the same at every step
    float hx = p.lx + vx, hy = p.ly + vy, hz = p.lz + vz;
    const float hn = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-12f);
    hx = hx / hn;
    hy = hy / hn;
    hz = hz / hn;
    const float expo = tex_dt * 150.0f;
    float prev_s = 0.0f;
    Fetch cur = fetch(grid, p, ox, oy, oz, dx, dy, dz, t0, jit, dt, 0);
    for (int k = 0; k < p.nsteps; ++k) {
      const float kf = (float)k;
      if (!(alpha < 0.995f) || !(kf * dt + t0 < t1)) break;  // not live
      const float s = blend(cur);
      const float t = t0 + (kf + jit) * dt;
      // step k + 1's loads go out before step k composites (clamped
      // indices: always in bounds; unused unless step k + 1 is live)
      const Fetch next = fetch(grid, p, ox, oy, oz, dx, dy, dz, t0, jit, dt, k + 1);
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
          const float gx = sample(grid, p, qx + p.h, qy, qz) - sample(grid, p, qx - p.h, qy, qz);
          const float gy = sample(grid, p, qx, qy + p.h, qz) - sample(grid, p, qx, qy - p.h, qz);
          const float gz = sample(grid, p, qx, qy, qz + p.h) - sample(grid, p, qx, qy, qz - p.h);
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
        const float u =
            fminf(fmaxf((s - p.vmin) / p.vspan, 0.0f), 1.0f) * (float)(p.ntf - 1);
        const int i0 = min(max((int)floorf(u), 0), p.ntf - 1);
        const int i1 = min(max(i0 + 1, 0), p.ntf - 1);
        const float f = u - (float)i0;
        const float g = 1.0f - f;
        const float4 a = __ldg(reinterpret_cast<const float4*>(tf) + i0);
        const float4 b = __ldg(reinterpret_cast<const float4*>(tf) + i1);
        const float ca = a.w * g + b.w * f;
        const float a_corr = 1.0f - powf(fmaxf(1.0f - ca, 1e-7f), expo);
        const float a_eff = trans * a_corr;
        float base[3];
        if (p.use_cvol) {
          sample3(cvol, p, ox + dx * t, oy + dy * t, oz + dz * t, base);
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
      cur = next;
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

// Launches the frame on `stream`, one thread per pixel in 8×4 warp tiles.
// `scal` is a host array of 14 floats (vmin vspan lx ly lz ambient
// one_m_amb specular shininess h bg_r bg_g bg_b bg_a), `cam` one of 42
// (inv_vp[16] inv_model[16] view_z[4] clip_min[3] clip_max[3]), `iso`
// n_iso groups of (value, r, g, b, a). `grid` (n0, n1, n2) and `cvol`
// (c0, c1, c2, 3) are row-major; `jitter`, `scene_depth` and `rays_out`
// may be null. Returns cudaGetLastError() right after the launch
// (1 = cudaErrorInvalidValue for n_iso beyond kMaxIso).
extern "C" int volume_launch(const float* grid, int n0, int n1, int n2,
                             const float* tf, int ntf, const float* cvol,
                             int c0, int c1, int c2, const float* jitter,
                             const float* scene_depth, int width, int height,
                             int nsteps, int enable_dvr, int use_cvol, int n_iso,
                             const float* scal, const float* cam,
                             const float* iso, float* rgba, float* depth,
                             float* rays_out, void* stream) {
  if (n_iso < 0 || n_iso > kMaxIso) return (int)cudaErrorInvalidValue;
  Params p;
  p.n0 = n0;
  p.n1 = n1;
  p.n2 = n2;
  p.ntf = ntf;
  p.c0 = c0;
  p.c1 = c1;
  p.c2 = c2;
  p.width = width;
  p.height = height;
  p.nsteps = nsteps;
  p.enable_dvr = enable_dvr;
  p.use_cvol = use_cvol;
  p.n_iso = n_iso;
  float* const scalars[14] = {&p.vmin,      &p.vspan,     &p.lx,       &p.ly,
                              &p.lz,        &p.ambient,   &p.one_m_amb, &p.specular,
                              &p.shininess, &p.h,         &p.bg_r,     &p.bg_g,
                              &p.bg_b,      &p.bg_a};
  for (int j = 0; j < 14; ++j) *scalars[j] = scal[j];
  for (int j = 0; j < 16; ++j) {
    p.inv_vp[j] = cam[j];
    p.inv_model[j] = cam[16 + j];
  }
  for (int j = 0; j < 4; ++j) p.view_z[j] = cam[32 + j];
  for (int j = 0; j < 3; ++j) {
    p.lo[j] = cam[36 + j];
    p.hi[j] = cam[39 + j];
  }
  for (int j = 0; j < kMaxIso; ++j) {
    const bool on = j < n_iso;
    p.iso_v[j] = on ? iso[j * 5] : 0.0f;
    for (int c = 0; c < 4; ++c) p.iso_c[j][c] = on ? iso[j * 5 + 1 + c] : 0.0f;
  }
  if (width > 0 && height > 0) {
    const dim3 blocks((width + kBlockW - 1) / kBlockW, (height + kBlockH - 1) / kBlockH);
    volume_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grid, tf, cvol, jitter, scene_depth, p, (float4*)rgba, depth, rays_out);
  }
  return (int)cudaGetLastError();
}
