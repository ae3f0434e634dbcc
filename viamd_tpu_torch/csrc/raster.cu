// Tiled sphere / half-capsule impostor ray cast for the molecule renderer,
// hand-written for Hopper (sm_90a), culled front to back.
//
// Replaces the TPU kernel viamd_tpu/render/pallas_raster.py::_raster_row_kernel
// (and its halo-row / tier layout built in render/raster.py::_raster_impl).
// For every pixel of a 16x16 tile it finds the nearest hit with t > 1e-6
// among the tile's candidate spheres, then its candidate half-capsules, and
// shades it:
//
//   ray: origin 0, direction (dx, dy, -1), dx = ((px + 0.5)·2/W − 1 + p02) /
//        p00 (p02, p12 carry the TAA jitter); t is the view depth −z.
//   sphere (c, r):   dc = d·c, disc = dc² − |d|²(|c|² − r²),
//                    t = (dc − sqrt(disc)) / |d|²                (:191-205)
//   half-capsule (p0, unit axis a, len L, r): the infinite cylinder about
//                    (p0, a), then the axial parameter clamped to [0, L],
//                    normal finished at the hit                  (:333-361)
//   shading: ambient + (1 − ambient)·max(n·l, 0) on the 8-bit packed colour,
//            plus specular·max(n·h, 0)^shininess; background bg·bga where
//            nothing is hit                                      (:429-462)
//
// Differences from the TPU kernel, by design:
//   * No candidate is dropped. The tile lists are CSR (start offsets + ids)
//     built by the caller from each primitive's conservative screen box,
//     with no capacity, no size tiers and no global huge tier (the TPU
//     kernel's per-row big-sphere list keeps 16 slots and drops the rest).
//   * The pick is an int32 atom id, exact at any atom count (the TPU kernel
//     carries ids as f32, exact below 2^24).
//   * Outputs are written in image layout: rgba (H, W, 4), depth (H, W),
//     pick (H, W); no tile-major planes to reassemble.
//   * The arithmetic is the plain PyTorch version's, operation for operation
//     (render/cuda_raster.py::raster_tiles_plain); the library is built with
//     -fmad=false and uses sqrtf and 1/sqrtf (no rsqrtf), so picks, alpha
//     and depth equal the plain version's and rgb differs only where powf
//     and torch.pow round differently.
//
// Culling. Testing every candidate of a tile's lists at every pixel of the
// tile takes ~1.5e8 ray tests at the 1080p water-box frame, though a pixel
// on the box's front face needs only the atoms within a few Å of its first
// hit. So the caller sorts each tile's lists by the primitives' near
// depth tlo (sphere −cz − r; half-capsule min(−z0, −z1) − r, z1 = qz +
// len·az; render/raster.py::bin_primitives), and:
//   * a block stages 256 candidates at a time into shared memory and
//     computes, once per candidate and not once per pixel, its tlo, its cull
//     depth and its per-primitive terms (sphere |c|² − r²; capsule p·a and
//     |p|² − (p·a)² − r²), with the plain version's operations in its order;
//   * a pixel is done with the rest of a list once a candidate's cull depth
//     exceeds its nearest hit bt: the lists are sorted, the cull depth is
//     monotone in tlo, so no later candidate can be nearer;
//   * a warp leaves its candidate loop when __all_sync says every lane is
//     done, and a block stops staging chunks when __syncthreads_and says
//     every thread is; pixels outside the frame start out done, pixels that
//     hit nothing never finish;
//   * the sqrt and the rest of a test run only where disc > 0.
//
// Tie rule. With lists in depth order, "first in list order wins a tie" no
// longer means "lowest id wins". So a candidate replaces the nearest hit
// when t < bt, or t == bt and its row i (in sph, or in cyl) is lower than
// the winner's row bi. Spheres come first; bi restarts at −1 for the
// capsules, so a capsule needs t < bt to replace a sphere. This equals the
// old strict `<` in primitive order pixel for pixel, whatever the list
// order (tests/test_torch_render.py::test_tie_rule_is_order_free).
//
// The margin. cull(tlo) = tlo·(1 ∓ 4e-3) − 1e-3 Å (− for tlo ≥ 0), so a
// candidate is skipped only if every hit it could report would lie more
// than 4e-3·depth + 1e-3 Å in front of its exact near depth. A real hit
// lies behind tlo: a sphere's surface spans depths [−cz − r, −cz + r]; a
// half-capsule's hit passes sax ∈ [0, L], so its axial point lies on the
// segment, and the hit lies within r of that point. The float32 hit is
// off by the rounding of disc, a difference of two ~dc²-sized terms: at
// most ~14 ulps of dc², so where disc → 0 (a silhouette) the sqrt moves t
// by up to ~sqrt(14·2⁻²⁴)·dc/|d|² ≈ 9e-4 of the depth, less the hit's
// distance behind tlo (~r·(1 − sinθ), θ the ray's angle off the view
// axis). Where a hit is that close to tlo the ray meets the surface head
// on, disc is large and t is exact to ~1e-6 relative. With the axis along
// the ray, A = max(|d|² − (d·a)², 1e-9) is clamped and t is
// ill-conditioned, but the sax test still keeps the hit within the
// segment's depth range. So the margin is ~4× the worst rounding; the
// sort key and the kernel's tlo are the same float operations and agree
// bit for bit. Held empirically by test_cull_margin (grazing and
// silhouette rays, end-on capsules, spheres at the eye plane, 0.1–0.25 Å
// primitives at 200–500 Å), whose largest shortfall below tlo is ~0.15 of
// the margin, and by chip_smoke.py, which compares every pixel of both
// 1080p frames with the unculled plain version.
//
// What bounds it on the H100: the output, 24 bytes a pixel (50 MB at
// 1920x1080, ~15 us at 3.35 TB/s), above the tests an exact cull must
// still do. chip_smoke.py prints that count beside the full one and both
// bounds; PERF.md records them. Later work: tile load balance (tiles at
// the box's silhouette and background pixels run their whole lists while
// front-face tiles finish early) and a persistent grid that hands tiles
// to blocks as they finish.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kParams = 17;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float p00, p11, p02, p12;      // projection diagonal and jitter
  float two_over_w, two_over_h;  // f32(2/W), f32(2/H)
  float ambient, one_m_amb, inv255, specular, shininess;
  float lx, ly, lz;              // unit light direction
  float bg_r, bg_g, bg_b;        // background rgb·alpha
};

// tlo − margin(tlo), monotone in tlo (render/cuda_raster.py::cull_depth:
// CULL_REL = 4e-3, CULL_ABS = 1e-3)
__device__ __forceinline__ float cull_depth(float tlo) {
  return tlo * (tlo >= 0.0f ? 0.996f : 1.004f) - 1e-3f;
}

__global__ void __launch_bounds__(kThreads) raster_tile_kernel(
    const float4* __restrict__ sph,    // (ns) cx cy cz r
    const int2* __restrict__ sph_ci,   // (ns) packed rgb, pick id
    const float4* __restrict__ cyl,    // (nc, 2) p0x p0y p0z ax | ay az len r
    const int2* __restrict__ cyl_ci,   // (nc) packed rgb, pick id
    const int* __restrict__ s_start,   // (T + 1) CSR offsets into s_list
    const int* __restrict__ s_list,    // sphere ids, tile by tile, near first
    const int* __restrict__ c_start,
    const int* __restrict__ c_list,
    int width, int height, int tiles_x, Params p,
    float4* __restrict__ rgba, float* __restrict__ depth,
    int* __restrict__ pick) {
  // staged candidates: sphere (c, r) | (|c|² − r², cull); capsule
  // (p0, ax) (ay, az, len, r) | (p·a, |p|² − (p·a)² − r², cull); colour,
  // pick id and row
  __shared__ float4 s_a[kThreads];
  __shared__ float4 s_b[kThreads];
  __shared__ float4 s_pre[kThreads];
  __shared__ int4 s_c[kThreads];

  const int tile = blockIdx.x;
  const int px = (tile % tiles_x) * kTile + (threadIdx.x % kTile);
  const int py = (tile / tiles_x) * kTile + (threadIdx.x / kTile);
  const bool outside = px >= width || py >= height;
  const float dx =
      (((float)px + 0.5f) * p.two_over_w - 1.0f + p.p02) * (1.0f / p.p00);
  const float dy =
      (((float)py + 0.5f) * p.two_over_h - 1.0f + p.p12) * (1.0f / p.p11);
  const float dd = dx * dx + dy * dy + 1.0f;
  const float inv_dd = 1.0f / dd;

  // nearest hit: sphere hits keep the centre and radius (normal resolved
  // once at the end); capsule hits keep the finished normal and hr = -1
  float bt = 1e30f;
  int bi = -1;  // the winner's row in its kind, for the tie rule
  int bid = -1;
  int bcol = 0;
  float hx = 0.0f, hy = 0.0f, hz = 0.0f, hr = 1.0f;

  bool done = outside;
  const int s0 = s_start[tile];
  const int s1 = s_start[tile + 1];
  for (int base = s0; base < s1; base += kThreads) {
    // also the barrier after the previous chunk
    if (__syncthreads_and(done)) break;
    const int n = min(kThreads, s1 - base);
    if (threadIdx.x < n) {
      const int i = s_list[base + threadIdx.x];
      const float4 c = sph[i];
      const int2 ci = sph_ci[i];
      s_a[threadIdx.x] = c;
      s_pre[threadIdx.x] = make_float4(
          c.x * c.x + c.y * c.y + c.z * c.z - c.w * c.w,
          cull_depth(-c.z - c.w), 0.0f, 0.0f);
      s_c[threadIdx.x] = make_int4(ci.x, ci.y, i, 0);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (__all_sync(kFull, done)) break;
      const float4 e = s_pre[k];
      done = done || e.y > bt;
      if (done) continue;
      const float4 c = s_a[k];
      const float dc = dx * c.x + dy * c.y - c.z;
      const float disc = dc * dc - dd * e.x;
      if (disc > 0.0f) {
        const float t = (dc - sqrtf(disc)) * inv_dd;
        const int4 ci = s_c[k];
        if (t > 1e-6f && (t < bt || (t == bt && ci.z < bi))) {
          bt = t;
          bi = ci.z;
          bid = ci.y;
          bcol = ci.x;
          hx = c.x;
          hy = c.y;
          hz = c.z;
          hr = c.w;
        }
      }
    }
  }

  bi = -1;  // a capsule needs t < bt to replace a sphere
  done = outside;
  const int c0 = c_start[tile];
  const int c1 = c_start[tile + 1];
  for (int base = c0; base < c1; base += kThreads) {
    if (__syncthreads_and(done)) break;
    const int n = min(kThreads, c1 - base);
    if (threadIdx.x < n) {
      const int i = c_list[base + threadIdx.x];
      const float4 a = cyl[2 * i];
      const float4 b = cyl[2 * i + 1];
      const int2 ci = cyl_ci[i];
      const float pa = a.x * a.w + a.y * b.x + a.z * b.y;
      const float z1 = a.z + b.z * b.y;
      s_a[threadIdx.x] = a;
      s_b[threadIdx.x] = b;
      s_pre[threadIdx.x] = make_float4(
          pa, a.x * a.x + a.y * a.y + a.z * a.z - pa * pa - b.w * b.w,
          cull_depth(fminf(-a.z, -z1) - b.w), 0.0f);
      s_c[threadIdx.x] = make_int4(ci.x, ci.y, i, 0);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (__all_sync(kFull, done)) break;
      const float4 e = s_pre[k];
      done = done || e.z > bt;
      if (done) continue;
      const float4 a = s_a[k];
      const float4 b = s_b[k];
      const float qx = a.x, qy = a.y, qz = a.z;
      const float ax = a.w, ay = b.x, az = b.y;
      const float len = b.z, rr = b.w;
      const float pa = e.x;
      const float da = dx * ax + dy * ay - az;
      const float dp = dx * qx + dy * qy - qz;
      const float A = fmaxf(dd - da * da, 1e-9f);
      const float Bq = dp - da * pa;
      const float disc = Bq * Bq - A * e.y;
      if (disc > 0.0f) {
        const float t = (Bq - sqrtf(disc)) / A;
        const float sax = t * da - pa;
        const int4 ci = s_c[k];
        if (t > 1e-6f && (t < bt || (t == bt && ci.z < bi)) && sax >= 0.0f &&
            sax <= len) {
          const float inv = 1.0f / fmaxf(rr, 1e-12f);
          bt = t;
          bi = ci.z;
          bid = ci.y;
          bcol = ci.x;
          hx = (dx * t - qx - sax * ax) * inv;
          hy = (dy * t - qy - sax * ay) * inv;
          hz = (-t - qz - sax * az) * inv;
          hr = -1.0f;
        }
      }
    }
  }

  if (outside) return;
  const int o = py * width + px;
  if (bid < 0) {
    rgba[o] = make_float4(p.bg_r, p.bg_g, p.bg_b, 0.0f);
    depth[o] = __int_as_float(0x7f800000);  // +inf
    pick[o] = -1;
    return;
  }
  float nx, ny, nz;
  if (hr < 0.0f) {
    nx = hx;
    ny = hy;
    nz = hz;
  } else {
    const float inv = 1.0f / fmaxf(hr, 1e-12f);
    nx = (dx * bt - hx) * inv;
    ny = (dy * bt - hy) * inv;
    nz = (-bt - hz) * inv;
  }
  const float ri = (float)((bcol >> 16) & 255);
  const float gi = (float)((bcol >> 8) & 255);
  const float bl = (float)(bcol & 255);
  const float ndl = fmaxf(nx * p.lx + ny * p.ly + nz * p.lz, 0.0f);
  const float vn = 1.0f / sqrtf(dd);
  const float hvx = p.lx + -dx * vn;
  const float hvy = p.ly + -dy * vn;
  const float hvz = p.lz + vn;
  const float hn =
      1.0f / sqrtf(fmaxf(hvx * hvx + hvy * hvy + hvz * hvz, 1e-24f));
  const float ndh = fmaxf((nx * hvx + ny * hvy + nz * hvz) * hn, 0.0f);
  const float lum = (p.ambient + p.one_m_amb * ndl) * p.inv255;
  const float spec = p.specular * powf(ndh, p.shininess);
  rgba[o] = make_float4(ri * lum + spec, gi * lum + spec, bl * lum + spec,
                        1.0f);
  depth[o] = bt;
  pick[o] = bid;
}

}  // namespace

extern "C" int raster_num_params() { return kParams; }

// Launches one block per tile on `stream`. `params` is a host array of
// kParams floats in Params order. Each tile's lists must be in ascending
// near depth (see the note above). Returns cudaGetLastError() right after
// the launch.
extern "C" int raster_launch(const float* sph, const int* sph_ci,
                             const float* cyl, const int* cyl_ci,
                             const int* s_start, const int* s_list,
                             const int* c_start, const int* c_list,
                             int width, int height, int tiles_x, int tiles_y,
                             const float* params, float* rgba, float* depth,
                             int* pick, void* stream) {
  Params p;
  p.p00 = params[0];
  p.p11 = params[1];
  p.p02 = params[2];
  p.p12 = params[3];
  p.two_over_w = params[4];
  p.two_over_h = params[5];
  p.ambient = params[6];
  p.one_m_amb = params[7];
  p.inv255 = params[8];
  p.specular = params[9];
  p.shininess = params[10];
  p.lx = params[11];
  p.ly = params[12];
  p.lz = params[13];
  p.bg_r = params[14];
  p.bg_g = params[15];
  p.bg_b = params[16];
  raster_tile_kernel<<<tiles_x * tiles_y, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float4*)sph, (const int2*)sph_ci, (const float4*)cyl,
      (const int2*)cyl_ci, s_start, s_list, c_start, c_list, width, height,
      tiles_x, p, (float4*)rgba, depth, pick);
  return (int)cudaGetLastError();
}
