// Gaussian-type-orbital grids (one orbital ψ, or the primitive matrix Φ of
// a run of voxels), hand-written for Hopper (sm_90a), screened exactly.
//
// Replaces the XLA fusion of viamd_tpu/ops/gto.py::eval_gto (:40-65) in the
// `lax.scan` bodies of eval_gto_grid (:103-130), density_grid (:303-326)
// and transition_density_grid (:329-355); not a Pallas kernel. Voxel
// (ix, iy, iz) of an (nx, ny, nz) grid, z fastest, has its centre at
//
//   p = origin + (i + 0.5)·voxel, world_j = p_x R_j0 + p_y R_j1 + p_z R_j2
//
// (R the grid's orientation, skipped when the grid is axis-aligned: the
// arithmetic of ops/gto.py::grid_points), and primitive k (centre c, α,
// powers l, m, n) contributes there
//
//   d = p − c, r² = (dx² + dy²) + dz², a = α·r²,
//   φ_k = (ipow(dx, l)·ipow(dy, m))·ipow(dz, n) · (a < 40 ? expf(−a) : 0)
//
// with ipow the JAX square-and-select in its order of products (three
// bits: out·b where the bit is set, then b·b). The library is built with
// -fmad=false, and expf is the correctly handled single-precision exp that
// torch.exp calls on the card, so φ equals ops/gto.py::primitive_matrix on
// CUDA tensors operation for operation.
//
// Two modes, one launch each:
//   * ψ (gto_psi_launch): ψ = Σ_k φ_k·c_k of one coefficient column over
//     the whole grid; each thread owns one voxel, φ lives in registers and
//     ψ is written once. The sum runs in primitive order, not torch.sum's,
//     so ψ is held to the plain version within 2·K·2⁻²⁴·Σ_k |φ_k·c_k| at
//     each voxel (both sums' float32 error bound).
//   * Φ (gto_phi_launch): rows c0 … c0 + n − 1 of the (P, K) primitive
//     matrix, voxels in z-fastest order, for the float32 product Φ @ C that
//     follows (torch.matmul, TF32 off). Φ equals the plain version bit
//     for bit.
//
// What bounds it on the H100: the pairs. Each (voxel, primitive) pair
// costs ~15 float32 operations and an expf; a "high" export grid of 944
// primitives is 9.4e9 pairs, and ψ mode moves only the 40 MB grid. So the
// kernel is bound by operations, and most pairs add exactly 0: a
// primitive's reach is sqrt(40/α), 0.1–15 bohr for 6-31G carbon, across a
// ~35×23×21 bohr grid.
//
// Exact screening. A ψ block takes a 4×8×8 brick of voxels (x, y, z), a Φ
// block 32 consecutive rows, and first computes the bounding box [lo, hi]
// of its voxel centres (their float32 coordinates, min and max). Per
// primitive it computes the gap g_x = lo_x − c_x (c_x < lo_x), c_x − hi_x
// (c_x > hi_x) or 0, d² = (g_x² + g_y²) + g_z², and skips the primitive for
// the whole block when α·d² ≥ 40. The margin is 0, and the skip is exact,
// not approximate: the gap is the same float32 subtraction as the plain
// version's d at the box's extreme voxel, and every later operation (the
// squares, the two sums in order, the product with α) is the same
// operation on arguments no larger, so by the monotonicity of IEEE
// round-to-nearest fl(α·r²) ≥ fl(α·d²) ≥ 40 at every voxel of the block,
// where the plain version gives 0. A ψ block compacts the primitives it
// keeps, 256 at a time, into shared memory (ballot and prefix counts) and
// every thread runs over that list with uniform branches on l, m, n; a Φ
// block writes 0 for the skipped columns. tests/test_torch_gto_kernel.py
// holds the screen's plain mirror (ops/gto.py::screen_keep) to the plain
// arithmetic on random, oriented and edge-of-cutoff bases; chip_smoke.py
// counts the pairs the kernel keeps with that mirror.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBX = 4, kBY = 8, kBZ = 8;  // ψ brick, z fastest
constexpr int kRows = 32;                 // Φ rows a block
constexpr float kCutoff = 40.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  float ox, oy, oz;  // origin, grid frame
  float vx, vy, vz;  // voxel size
  float r[9];        // orientation, row-major
  int oriented;
  int nx, ny, nz;
};

__device__ __forceinline__ float3 voxel_center(const Grid& g, int ix, int iy,
                                               int iz) {
  const float px = g.ox + ((float)ix + 0.5f) * g.vx;
  const float py = g.oy + ((float)iy + 0.5f) * g.vy;
  const float pz = g.oz + ((float)iz + 0.5f) * g.vz;
  if (!g.oriented) return make_float3(px, py, pz);
  return make_float3(px * g.r[0] + py * g.r[1] + pz * g.r[2],
                     px * g.r[3] + py * g.r[4] + pz * g.r[5],
                     px * g.r[6] + py * g.r[7] + pz * g.r[8]);
}

__device__ __forceinline__ float ipow(float b, int e) {
  float out = 1.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out = (e & 1) ? out * b : out;
    b = b * b;
    e >>= 1;
  }
  return out;
}

// φ of primitive (c, α) with packed powers lmn (l | m << 4 | n << 8)
__device__ __forceinline__ float phi(float3 p, float4 c, int lmn) {
  const float dx = p.x - c.x, dy = p.y - c.y, dz = p.z - c.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float ar2 = c.w * r2;
  const float ang =
      ipow(dx, lmn & 15) * ipow(dy, (lmn >> 4) & 15) * ipow(dz, lmn >> 8);
  const float rad = ar2 < kCutoff ? expf(-ar2) : 0.0f;
  return ang * rad;
}

// true when primitive (c, α) adds exactly 0 at every voxel of [lo, hi]
__device__ __forceinline__ bool skip(float4 c, float3 lo, float3 hi) {
  const float gx = c.x < lo.x ? lo.x - c.x : (c.x > hi.x ? c.x - hi.x : 0.0f);
  const float gy = c.y < lo.y ? lo.y - c.y : (c.y > hi.y ? c.y - hi.y : 0.0f);
  const float gz = c.z < lo.z ? lo.z - c.z : (c.z > hi.z ? c.z - hi.z : 0.0f);
  const float d2 = gx * gx + gy * gy + gz * gz;
  return c.w * d2 >= kCutoff;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ψ over one brick a block. prim: (K, 2) float4, (c, α) | (coef, lmn bits)
__global__ void __launch_bounds__(kThreads) gto_psi_kernel(
    const float4* __restrict__ prim, int K, Grid g, int bricks_y,
    int bricks_z, float* __restrict__ out) {
  __shared__ float4 s_c[kThreads];
  __shared__ float2 s_k[kThreads];  // coef, lmn bits
  __shared__ float s_box[6][kWarps];
  __shared__ int s_count[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int ix = (b / (bricks_y * bricks_z)) * kBX + t / (kBY * kBZ);
  const int iy = ((b / bricks_z) % bricks_y) * kBY + (t / kBZ) % kBY;
  const int iz = (b % bricks_z) * kBZ + t % kBZ;
  const bool active = ix < g.nx && iy < g.ny && iz < g.nz;
  const float3 p = voxel_center(g, ix, iy, iz);

  // the brick's bounding box over its active voxel centres
  const float inf = __int_as_float(0x7f800000);
  float v[6] = {active ? p.x : inf,  active ? p.y : inf,  active ? p.z : inf,
                active ? p.x : -inf, active ? p.y : -inf, active ? p.z : -inf};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[j] = warp_min(v[j]);
    v[j + 3] = warp_max(v[j + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) s_box[j][warp] = v[j];
  }
  __syncthreads();
  float3 lo = make_float3(inf, inf, inf), hi = make_float3(-inf, -inf, -inf);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo.x = fminf(lo.x, s_box[0][w]);
    lo.y = fminf(lo.y, s_box[1][w]);
    lo.z = fminf(lo.z, s_box[2][w]);
    hi.x = fmaxf(hi.x, s_box[3][w]);
    hi.y = fmaxf(hi.y, s_box[4][w]);
    hi.z = fmaxf(hi.z, s_box[5][w]);
  }

  float psi = 0.0f;
  for (int base = 0; base < K; base += kThreads) {
    const int k = base + t;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f), e = c;
    bool keep = false;
    if (k < K) {
      c = prim[2 * k];
      e = prim[2 * k + 1];
      keep = !skip(c, lo, hi);
    }
    const unsigned m = __ballot_sync(kFull, keep);
    __syncthreads();  // the previous chunk's list is read
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_count[w] : 0;
      n += s_count[w];
    }
    if (keep) {
      const int slot = off + __popc(m & ((1u << lane) - 1u));
      s_c[slot] = c;
      s_k[slot] = make_float2(e.x, e.y);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float2 ck = s_k[j];
        psi = psi + phi(p, s_c[j], __float_as_int(ck.y)) * ck.x;
      }
    }
  }
  if (active) out[((size_t)ix * g.ny + iy) * g.nz + iz] = psi;
}

// Φ rows c0 + blockIdx.x·32 … of the (n, K) chunk, z-fastest voxels
__global__ void __launch_bounds__(kThreads) gto_phi_kernel(
    const float4* __restrict__ prim, int K, Grid g, long long c0, int n,
    float* __restrict__ out) {
  __shared__ float4 s_p[kRows];
  __shared__ float s_box[6];

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int t = threadIdx.x;
  if (t < 32) {
    const bool active = t < rows;
    const long long vox = c0 + row0 + (active ? t : 0);
    const int iz = (int)(vox % g.nz);
    const int iy = (int)((vox / g.nz) % g.ny);
    const int ix = (int)(vox / ((long long)g.nz * g.ny));
    const float3 p = voxel_center(g, ix, iy, iz);
    s_p[t] = make_float4(p.x, p.y, p.z, 0.0f);
    const float inf = __int_as_float(0x7f800000);
    const float lx = warp_min(active ? p.x : inf);
    const float ly = warp_min(active ? p.y : inf);
    const float lz = warp_min(active ? p.z : inf);
    const float hx = warp_max(active ? p.x : -inf);
    const float hy = warp_max(active ? p.y : -inf);
    const float hz = warp_max(active ? p.z : -inf);
    if (t == 0) {
      s_box[0] = lx;
      s_box[1] = ly;
      s_box[2] = lz;
      s_box[3] = hx;
      s_box[4] = hy;
      s_box[5] = hz;
    }
  }
  __syncthreads();
  const float3 lo = make_float3(s_box[0], s_box[1], s_box[2]);
  const float3 hi = make_float3(s_box[3], s_box[4], s_box[5]);

  for (int k = t; k < K; k += kThreads) {
    const float4 c = prim[2 * k];
    const int lmn = __float_as_int(prim[2 * k + 1].y);
    float* col = out + (size_t)row0 * K + k;
    if (skip(c, lo, hi)) {
      for (int r = 0; r < rows; ++r) col[(size_t)r * K] = 0.0f;
    } else {
      for (int r = 0; r < rows; ++r) {
        const float4 q = s_p[r];
        col[(size_t)r * K] = phi(make_float3(q.x, q.y, q.z), c, lmn);
      }
    }
  }
}

Grid make_grid(const float* gp, int oriented, int nx, int ny, int nz) {
  Grid g;
  g.ox = gp[0];
  g.oy = gp[1];
  g.oz = gp[2];
  g.vx = gp[3];
  g.vy = gp[4];
  g.vz = gp[5];
  for (int j = 0; j < 9; ++j) g.r[j] = gp[6 + j];
  g.oriented = oriented;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  return g;
}

}  // namespace

// `gp` is a host array of 15 floats: origin (3), voxel (3), orientation
// (3x3, row-major; read only when `oriented` is 1). Each returns
// cudaGetLastError() right after the launch.
extern "C" int gto_psi_launch(const float* prim, int K, const float* gp,
                              int oriented, int nx, int ny, int nz,
                              float* out, void* stream) {
  const Grid g = make_grid(gp, oriented, nx, ny, nz);
  const int by = (ny + kBY - 1) / kBY, bz = (nz + kBZ - 1) / kBZ;
  const long long blocks = (long long)((nx + kBX - 1) / kBX) * by * bz;
  gto_psi_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)prim, K, g, by, bz, out);
  return (int)cudaGetLastError();
}

extern "C" int gto_phi_launch(const float* prim, int K, const float* gp,
                              int oriented, int nx, int ny, int nz,
                              long long c0, int n, float* out,
                              void* stream) {
  const Grid g = make_grid(gp, oriented, nx, ny, nz);
  gto_phi_kernel<<<(n + kRows - 1) / kRows, kThreads, 0,
                   (cudaStream_t)stream>>>((const float4*)prim, K, g, c0, n,
                                           out);
  return (int)cudaGetLastError();
}
