// Tiled triangle ray cast for the ribbon / cartoon meshes, the overlay's
// filled triangles and the dipole arrows, hand-written for Hopper (sm_90a).
//
// Replaces the XLA tile kernel viamd_tpu/render/triangles.py::_tile_kernel
// (:30-117; not a Pallas kernel: a `fori_loop` over at most 64 padded slots
// a tile). For every pixel of a 16x16 tile it finds the nearest two-sided
// Moller-Trumbore hit among the tile's candidate triangles and writes rgba,
// view depth and pick:
//
//   ray: origin 0, direction d = (dx, dy, -1) in view space, with
//        px = (ox + lx) + 0.5, ndc_x = px / W * 2 - 1, dx = ndc_x / p00,
//        ndc_y = 1 - py / H * 2, dy = ndc_y / p11               (:37-45)
//   per candidate (once, at staging): e1 = v1 - v0, e2 = v2 - v0,
//        tvec = -v0, qvec = tvec x e1, tnum = qvec . e2, the unit face
//        normal n = (e1 x e2) / max(|e1 x e2|, 1e-12)
//   per pixel and candidate: pvec = d x e2, det = pvec . e1,
//        inv = |det| > 1e-12 ? 1 / det : 0, u = (tvec . pvec) inv,
//        v = (qvec . d) inv, t = tnum inv; a hit when |det| > 1e-12,
//        u >= 0, v >= 0, u + v <= 1, t > 1e-3 and t < best (strict: the
//        first candidate in list order keeps a tie); the hit's normal is
//        flipped toward the viewer when n . d > 0                (:53-88)
//   shading (:97-116): rgb (0.25 + 0.75 max(n.l, 0)) + 0.25 max(n.h, 0)^32,
//        h = (l - d/|d|) / max(|l - d/|d||, 1e-12), clipped to [0, 1];
//        flat (rgb clipped) when shade is 0; alpha is the triangle's;
//        nothing hit: rgba 0, depth +inf, pick -1.
//
// Every cross product is jnp.cross's component formula, every dot product
// is summed left to right, and the library is built with -fmad=false, so
// the kernel equals its plain version (render/triangles.py::
// raster_triangles_plain, which repeats these operations in this order,
// with correctly rounded divisions and square roots) bit for bit, x^32
// included: five squarings, as jnp's integer power lowers it.
//
// Differences from the XLA kernel, by design:
//   * No candidate is dropped. The tile lists are CSR (start offsets + ids)
//     in ascending near depth, ties in triangle order, built by the caller
//     from each triangle's projected box (render/triangles.py::
//     bin_triangles, the JAX binning rule) with no capacity; the XLA kernel
//     keeps the nearest 64 of a tile (`max_per_tile`).
//   * The pick is an int32, exact at any id (the XLA kernel carries picks
//     as f32, exact below 2^24).
//   * Outputs are written in image layout: rgba (H, W, 4), depth (H, W),
//     pick (H, W).
//
// What bounds it on the H100: the ray tests, one per (pixel, candidate of
// its tile) — ~36 float32 operations and a division each — against the
// outputs' 24 bytes a pixel. At the 1080p cartoon frame chip_smoke.py
// counts 100,301 tile entries, 25,677,056 tests, ~0.95 GFLOP: ~0.014 ms at
// 67 TFLOP/s, below the ~16 us the outputs and lists take at 3.35 TB/s, so
// bytes bound it. The design: one block a tile, one thread a pixel; the block stages
// 256 candidates at a time into shared memory and computes every
// pixel-independent term of a candidate there once (e1, e2, tvec, qvec,
// tnum, n), so a test is a cross product, three dot products, a division
// and the comparisons, all from registers and broadcast shared loads.
// Tiles with long lists (at most ~300 at the cartoon frame) run longest.
// No cull: an exact front-to-back cull (each candidate's t bounded over
// its tile, a suffix minimum along the sorted list, a warp vote to leave
// the list, as csrc/raster.cu does) did 76% of the tests at the cartoon
// frame and ran slower there than this kernel, as did every cheaper-test
// variant tried (PERF.md, Findings): 55% of the tests are at pixels that
// hit nothing, which no cull shortens.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

struct Params {
  float p00, p11;      // projection diagonal
  float lx, ly, lz;    // light direction (as given, not normalized)
  int shade;           // 1: lit, 0: flat
};

__global__ void __launch_bounds__(kThreads) triangle_tile_kernel(
    const float* __restrict__ tri,     // (T, 3, 3) view-space vertices
    const float4* __restrict__ color,  // (T) rgba
    const int* __restrict__ pick_in,   // (T) pick ids
    const int* __restrict__ start,     // (tiles + 1) CSR offsets into list
    const int* __restrict__ list,      // triangle ids, tile by tile
    int width, int height, int tiles_x, Params p,
    float4* __restrict__ rgba, float* __restrict__ depth,
    int* __restrict__ pick) {
  // staged candidates: (tvec, tnum), (e1, id), (e2, -), (qvec, -), (n, -)
  __shared__ float4 s_t[kThreads];
  __shared__ float4 s_e1[kThreads];
  __shared__ float4 s_e2[kThreads];
  __shared__ float4 s_q[kThreads];
  __shared__ float4 s_n[kThreads];

  const int tile = blockIdx.x;
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const int ix = (tile % tiles_x) * kTile + lx;
  const int iy = (tile / tiles_x) * kTile + ly;
  const float px = (float)ix + 0.5f;
  const float py = (float)iy + 0.5f;
  const float ndc_x = px / (float)width * 2.0f - 1.0f;
  const float ndc_y = 1.0f - py / (float)height * 2.0f;
  const float dx = ndc_x / p.p00;
  const float dy = ndc_y / p.p11;
  const float dz = -1.0f;

  float bt = __int_as_float(0x7f800000);  // +inf
  int bi = -1;
  float bnx = 0.0f, bny = 0.0f, bnz = 0.0f;

  const int l0 = start[tile];
  const int l1 = start[tile + 1];
  for (int base = l0; base < l1; base += kThreads) {
    __syncthreads();  // the previous chunk is read
    const int n = min(kThreads, l1 - base);
    if (threadIdx.x < n) {
      const int i = list[base + threadIdx.x];
      const float* v = tri + 9 * (size_t)i;
      const float v0x = v[0], v0y = v[1], v0z = v[2];
      const float e1x = v[3] - v0x, e1y = v[4] - v0y, e1z = v[5] - v0z;
      const float e2x = v[6] - v0x, e2y = v[7] - v0y, e2z = v[8] - v0z;
      const float tx = -v0x, ty = -v0y, tz = -v0z;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float tnum = qx * e2x + qy * e2y + qz * e2z;
      float nx = e1y * e2z - e1z * e2y;
      float ny = e1z * e2x - e1x * e2z;
      float nz = e1x * e2y - e1y * e2x;
      const float nl = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-12f);
      nx = nx / nl;
      ny = ny / nl;
      nz = nz / nl;
      s_t[threadIdx.x] = make_float4(tx, ty, tz, tnum);
      s_e1[threadIdx.x] = make_float4(e1x, e1y, e1z, __int_as_float(i));
      s_e2[threadIdx.x] = make_float4(e2x, e2y, e2z, 0.0f);
      s_q[threadIdx.x] = make_float4(qx, qy, qz, 0.0f);
      s_n[threadIdx.x] = make_float4(nx, ny, nz, 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 e1 = s_e1[k];
      const float4 e2 = s_e2[k];
      const float pvx = dy * e2.z - dz * e2.y;
      const float pvy = dz * e2.x - dx * e2.z;
      const float pvz = dx * e2.y - dy * e2.x;
      const float det = pvx * e1.x + pvy * e1.y + pvz * e1.z;
      const bool ok = fabsf(det) > 1e-12f;
      const float inv = ok ? 1.0f / det : 0.0f;
      const float4 tv = s_t[k];
      const float4 q = s_q[k];
      const float u = (tv.x * pvx + tv.y * pvy + tv.z * pvz) * inv;
      const float w = (q.x * dx + q.y * dy + q.z * dz) * inv;
      const float t = tv.w * inv;
      if (ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > 1e-3f &&
          t < bt) {
        const float4 nn = s_n[k];
        const bool flip = nn.x * dx + nn.y * dy + nn.z * dz > 0.0f;
        bt = t;
        bi = __float_as_int(e1.w);
        bnx = flip ? -nn.x : nn.x;
        bny = flip ? -nn.y : nn.y;
        bnz = flip ? -nn.z : nn.z;
      }
    }
  }

  if (ix >= width || iy >= height) return;
  const int o = iy * width + ix;
  if (bi < 0) {
    rgba[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    depth[o] = __int_as_float(0x7f800000);
    pick[o] = -1;
    return;
  }
  const float4 c = color[bi];
  float r = c.x, g = c.y, b = c.z;
  if (p.shade) {
    const float nd = sqrtf(dx * dx + dy * dy + dz * dz);
    const float dnx = dx / nd, dny = dy / nd, dnz = dz / nd;
    const float ndotl = fmaxf(bnx * p.lx + bny * p.ly + bnz * p.lz, 0.0f);
    float hx = p.lx - dnx, hy = p.ly - dny, hz = p.lz - dnz;
    const float hl = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-12f);
    hx = hx / hl;
    hy = hy / hl;
    hz = hz / hl;
    float s = fmaxf(bnx * hx + bny * hy + bnz * hz, 0.0f);
    s = s * s;  // x^2
    s = s * s;  // x^4
    s = s * s;  // x^8
    s = s * s;  // x^16
    s = s * s;  // x^32
    const float lum = 0.25f + 0.75f * ndotl;
    const float spec = 0.25f * s;
    r = r * lum + spec;
    g = g * lum + spec;
    b = b * lum + spec;
  }
  rgba[o] = make_float4(fminf(fmaxf(r, 0.0f), 1.0f), fminf(fmaxf(g, 0.0f), 1.0f),
                        fminf(fmaxf(b, 0.0f), 1.0f), c.w);
  depth[o] = bt;
  pick[o] = pick_in[bi];
}

}  // namespace

// Launches one block per tile on `stream`. Returns cudaGetLastError() right
// after the launch.
extern "C" int triangles_launch(const float* tri, const float* color,
                                const int* pick_in, const int* start,
                                const int* list, int width, int height,
                                int tiles_x, int tiles_y, float p00, float p11,
                                float lx, float ly, float lz, int shade,
                                float* rgba, float* depth, int* pick,
                                void* stream) {
  Params p{p00, p11, lx, ly, lz, shade};
  triangle_tile_kernel<<<tiles_x * tiles_y, kThreads, 0,
                         (cudaStream_t)stream>>>(
      tri, (const float4*)color, pick_in, start, list, width, height, tiles_x,
      p, (float4*)rgba, depth, pick);
  return (int)cudaGetLastError();
}
