// Tiled sphere / half-capsule impostor ray cast for the molecule renderer,
// hand-written for Hopper (sm_90a).
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
//   * Every candidate of a tile is tested. The tile lists are CSR (start
//     offsets + ids) built by the caller from each primitive's conservative
//     screen box, with no capacity, no size tiers and no global huge tier,
//     so nothing is dropped (the TPU kernel's per-row big-sphere list keeps
//     16 slots and drops the rest).
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
// What bounds it on the H100: at the 1080p water-box frame (100,002 atoms,
// spacefill) the lists hold ~5.8e5 (tile, sphere) entries, so ~1.5e8
// ray-sphere tests of 21 f32 operations: ~3.1 GFLOP, ~47 us at 67 TFLOP/s.
// The output is 24 bytes a pixel, 50 MB at 1920x1080, ~15 us at 3.35 TB/s.
// So it is bound by operations. The simple design: one 256-thread block per
// tile, one pixel per thread, nearest hit in registers; the tile's
// candidates staged through shared memory 256 at a time (one coalesced load
// per thread per chunk) and tested by every thread in list order with a
// strict `<` on t, so the result is deterministic. Depth-sorted early exit,
// warp-level culling and tile load balance are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kParams = 17;

struct Params {
  float p00, p11, p02, p12;      // projection diagonal and jitter
  float two_over_w, two_over_h;  // f32(2/W), f32(2/H)
  float ambient, one_m_amb, inv255, specular, shininess;
  float lx, ly, lz;              // unit light direction
  float bg_r, bg_g, bg_b;        // background rgb·alpha
};

__global__ void __launch_bounds__(kThreads) raster_tile_kernel(
    const float4* __restrict__ sph,    // (ns) cx cy cz r
    const int2* __restrict__ sph_ci,   // (ns) packed rgb, pick id
    const float4* __restrict__ cyl,    // (nc, 2) p0x p0y p0z ax | ay az len r
    const int2* __restrict__ cyl_ci,   // (nc) packed rgb, pick id
    const int* __restrict__ s_start,   // (T + 1) CSR offsets into s_list
    const int* __restrict__ s_list,    // sphere ids, tile by tile
    const int* __restrict__ c_start,
    const int* __restrict__ c_list,
    int width, int height, int tiles_x, Params p,
    float4* __restrict__ rgba, float* __restrict__ depth,
    int* __restrict__ pick) {
  __shared__ float4 s_a[kThreads];
  __shared__ float4 s_b[kThreads];
  __shared__ int2 s_c[kThreads];

  const int tile = blockIdx.x;
  const int px = (tile % tiles_x) * kTile + (threadIdx.x % kTile);
  const int py = (tile / tiles_x) * kTile + (threadIdx.x / kTile);
  const float dx =
      (((float)px + 0.5f) * p.two_over_w - 1.0f + p.p02) * (1.0f / p.p00);
  const float dy =
      (((float)py + 0.5f) * p.two_over_h - 1.0f + p.p12) * (1.0f / p.p11);
  const float dd = dx * dx + dy * dy + 1.0f;
  const float inv_dd = 1.0f / dd;

  // nearest hit: sphere hits keep the centre and radius (normal resolved
  // once at the end); capsule hits keep the finished normal and hr = -1
  float bt = 1e30f;
  int bid = -1;
  int bcol = 0;
  float hx = 0.0f, hy = 0.0f, hz = 0.0f, hr = 1.0f;

  const int s0 = s_start[tile];
  const int s1 = s_start[tile + 1];
  for (int base = s0; base < s1; base += kThreads) {
    const int n = min(kThreads, s1 - base);
    __syncthreads();  // the previous chunk is consumed
    if (threadIdx.x < n) {
      const int i = s_list[base + threadIdx.x];
      s_a[threadIdx.x] = sph[i];
      s_c[threadIdx.x] = sph_ci[i];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 c = s_a[k];
      const float cc = c.x * c.x + c.y * c.y + c.z * c.z - c.w * c.w;
      const float dc = dx * c.x + dy * c.y - c.z;
      const float disc = dc * dc - dd * cc;
      const float t = (dc - sqrtf(fmaxf(disc, 0.0f))) * inv_dd;
      if (disc > 0.0f && t > 1e-6f && t < bt) {
        bt = t;
        bid = s_c[k].y;
        bcol = s_c[k].x;
        hx = c.x;
        hy = c.y;
        hz = c.z;
        hr = c.w;
      }
    }
  }

  const int c0 = c_start[tile];
  const int c1 = c_start[tile + 1];
  for (int base = c0; base < c1; base += kThreads) {
    const int n = min(kThreads, c1 - base);
    __syncthreads();
    if (threadIdx.x < n) {
      const int i = c_list[base + threadIdx.x];
      s_a[threadIdx.x] = cyl[2 * i];
      s_b[threadIdx.x] = cyl[2 * i + 1];
      s_c[threadIdx.x] = cyl_ci[i];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 a = s_a[k];
      const float4 b = s_b[k];
      const float qx = a.x, qy = a.y, qz = a.z;
      const float ax = a.w, ay = b.x, az = b.y;
      const float len = b.z, rr = b.w;
      const float pa = qx * ax + qy * ay + qz * az;
      const float cc2 = qx * qx + qy * qy + qz * qz - pa * pa - rr * rr;
      const float da = dx * ax + dy * ay - az;
      const float dp = dx * qx + dy * qy - qz;
      const float A = fmaxf(dd - da * da, 1e-9f);
      const float Bq = dp - da * pa;
      const float disc = Bq * Bq - A * cc2;
      const float t = (Bq - sqrtf(fmaxf(disc, 0.0f))) / A;
      const float sax = t * da - pa;
      if (disc > 0.0f && t > 1e-6f && t < bt && sax >= 0.0f && sax <= len) {
        const float inv = 1.0f / fmaxf(rr, 1e-12f);
        bt = t;
        bid = s_c[k].y;
        bcol = s_c[k].x;
        hx = (dx * t - qx - sax * ax) * inv;
        hy = (dy * t - qy - sax * ay) * inv;
        hz = (-t - qz - sax * az) * inv;
        hr = -1.0f;
      }
    }
  }

  if (px >= width || py >= height) return;
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
  const float bi = (float)(bcol & 255);
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
  rgba[o] = make_float4(ri * lum + spec, gi * lum + spec, bi * lum + spec,
                        1.0f);
  depth[o] = bt;
  pick[o] = bid;
}

}  // namespace

extern "C" int raster_num_params() { return kParams; }

// Launches one block per tile on `stream`. `params` is a host array of
// kParams floats in Params order. Returns cudaGetLastError() right after
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
