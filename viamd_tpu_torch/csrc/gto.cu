// Gaussian-type-orbital grids (one orbital ψ, or a density ρ = Σ_m w_m ·
// (ΦA)_m · (ΦB)_m over coefficient columns), hand-written for Hopper
// (sm_90a), screened exactly. Neither mode writes the primitive matrix Φ.
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
// Two modes, one launch a grid each, one block a brick of voxels:
//   * ψ (gto_psi_launch): ψ = Σ_k φ_k·c_k of one coefficient column over
//     4×8×8 bricks; each thread owns one voxel, φ lives in registers and
//     ψ is written once. The sum runs in primitive order, not torch.sum's,
//     so ψ is held to the plain version within 2·K·2⁻²⁴·Σ_k |φ_k·c_k| at
//     each voxel (both sums' float32 error bound).
//   * ρ (gto_rho_launch): ρ = Σ_m w_m·(ΦA)_m·(ΦB)_m over 4×4×4 bricks. The
//     electron density takes A = B = C (the occupied columns) and w the
//     occupations; a transition density takes A = C_occ·T and B = C_virt
//     (K × nvirt, the product folded on the host side of the launch) and
//     w = 1.
//
// What bounds it on the H100: operations. Each (voxel, primitive) pair
// costs ~15 float32 operations and an expf, and in ρ mode 2·M more for
// its share of the contraction; a "high" export grid of 944 primitives is
// 9.4e9 pairs, and either mode moves little more than the 40 MB grid. Most
// pairs add exactly 0: a primitive's reach is sqrt(40/α), 0.1–15 bohr for
// 6-31G carbon, across a ~35×23×21 bohr grid.
//
// Exact screening. A block first computes the bounding box [lo, hi] of its
// brick's voxel centres (their float32 coordinates, min and max). Per
// primitive it computes the gap g_x = lo_x − c_x (c_x < lo_x), c_x − hi_x
// (c_x > hi_x) or 0, d² = (g_x² + g_y²) + g_z², and skips the primitive for
// the whole block when α·d² ≥ 40. The margin is 0, and the skip is exact,
// not approximate: the gap is the same float32 subtraction as the plain
// version's d at the box's extreme voxel, and every later operation (the
// squares, the two sums in order, the product with α) is the same
// operation on arguments no larger, so by the monotonicity of IEEE
// round-to-nearest fl(α·r²) ≥ fl(α·d²) ≥ 40 at every voxel of the block,
// where the plain version gives 0. The block compacts the primitives it
// keeps (ballot and prefix counts) into shared memory and runs over that
// list only. tests/test_torch_gto_kernel.py holds the screen's plain mirror
// (ops/cuda_gto.py::screen_keep) to the plain arithmetic on random,
// oriented and edge-of-cutoff bases; chip_smoke.py counts the pairs the
// kernel keeps with that mirror.
//
// ρ mode's design. Before it, a density was a Φ kernel writing 65,536 ×
// 944 float32 rows a launch (247 MB, 87% of it zeros) and a dense float32
// torch.matmul over them: 37.8 GB of Φ through device memory for the
// "high" grid. Now a block of 256 threads keeps a 4×4×4 brick's whole
// contraction on the chip:
//   1. the brick's kept primitives go into a list in dynamic shared memory
//      (2 bytes each, in primitive order);
//   2. the columns go in passes of 256 (128 for a transition density,
//      which carries two products), so one pass covers most densities;
//      per pass, the list in chunks of 64: the chunk's primitives and
//      rows of A (and B) are gathered into shared memory with cp.async
//      (two groups), the threads evaluate φ of the chunk at the brick's 64
//      voxels (four threads a voxel, every fourth primitive) into a shared
//      64 × 64 tile while the rows are in flight;
//   3. each thread accumulates a 4-voxel × 16-column register tile of ΦA
//      (4 × 8 of ΦA and of ΦB) with explicit fmaf over the chunk: per
//      primitive one 16-byte load of φ and broadcast loads of the rows. Its
//      columns are 4-column groups spread over the warps, the same count in
//      both halves of a warp, and the loop is instantiated per count, so
//      it holds no branch and a narrow pass still spreads over the warps;
//   4. at the end of a pass each thread sums w_m·(ΦA)_m·(ΦB)_m over its
//      columns in order, the sixteen half-warps' partial sums are added in
//      a fixed order through shared memory, and ρ is carried in a register;
//      it is written once. No atomics: two runs give the same bits.
// φ has no branch (the powers by select, the exp taken before the cutoff's
// select), so the compiler overlaps a thread's sixteen evaluations.
// A column count not a multiple of 16 is padded with zero columns (and
// zero weights) by the wrapper. The sums over primitives run in list
// order with fused multiply-adds, so ρ is held to the plain version
// (Φ @ C by chunks) within 2·(2K + M + 8)·2⁻²⁴·Σ_m |w_m|·(|Φ||A|)_m·(|Φ||B|)_m
// at each voxel (both versions' float32 error bounds, first order).
// Why this layout: the register tile (64 accumulators a thread, two
// blocks an SM) fixes a pass at 256 columns over 64 voxels; a larger brick
// would need narrower passes, and every pass evaluates φ again (for the
// 140-column "high" density, 4×8×8 bricks would take three). Branches in φ
// or in the product loop serialize a thread's work there. The timed
// alternatives (chunks of 32, the loop unrolled twice, three blocks an SM,
// branches in φ) are `python -m viamd_tpu_torch.profile_gto --variants`;
// PERF.md §6 has their times on the H100.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBX = 4, kBY = 8, kBZ = 8;  // a ψ block's brick, z fastest
constexpr int kRX = 4, kRY = 4, kRZ = 4;  // a ρ block's brick
constexpr int kRVox = kRX * kRY * kRZ;    // its voxels, four threads each
constexpr int kChunk = 64;                // ρ: kept primitives a chunk
constexpr float kCutoff = 40.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  float ox, oy, oz;  // origin, grid frame
  float vx, vy, vz;  // voxel size
  float r[9];        // orientation, row-major
  int oriented;
  int nx, ny, nz;
};

// this thread's voxel of the block's brick
struct Voxel {
  int ix, iy, iz;
  bool active;  // inside the grid
  float3 p;     // centre, world frame
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

// voxel u (z fastest) of this block's BX×BY×BZ brick
template <int BX, int BY, int BZ>
__device__ __forceinline__ Voxel brick_voxel(const Grid& g, int bricks_y,
                                             int bricks_z, int u) {
  const int b = blockIdx.x;
  Voxel v;
  v.ix = (b / (bricks_y * bricks_z)) * BX + u / (BY * BZ);
  v.iy = ((b / bricks_z) % bricks_y) * BY + (u / BZ) % BY;
  v.iz = (b % bricks_z) * BZ + u % BZ;
  v.active = v.ix < g.nx && v.iy < g.ny && v.iz < g.nz;
  v.p = voxel_center(g, v.ix, v.iy, v.iz);
  return v;
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
  const float ex = expf(-ar2);  // finite for any finite α·r², so no branch
  const float rad = ar2 < kCutoff ? ex : 0.0f;
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

// [lo, hi]: the bounding box of the block's active voxel centres
__device__ __forceinline__ void brick_box(const Voxel& v,
                                          float (*s_box)[kWarps], float3& lo,
                                          float3& hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  float b[6] = {v.active ? v.p.x : inf,  v.active ? v.p.y : inf,
                v.active ? v.p.z : inf,  v.active ? v.p.x : -inf,
                v.active ? v.p.y : -inf, v.active ? v.p.z : -inf};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    b[j] = warp_min(b[j]);
    b[j + 3] = warp_max(b[j + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) s_box[j][warp] = b[j];
  }
  __syncthreads();
  lo = make_float3(inf, inf, inf);
  hi = make_float3(-inf, -inf, -inf);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo.x = fminf(lo.x, s_box[0][w]);
    lo.y = fminf(lo.y, s_box[1][w]);
    lo.z = fminf(lo.z, s_box[2][w]);
    hi.x = fmaxf(hi.x, s_box[3][w]);
    hi.y = fmaxf(hi.y, s_box[4][w]);
    hi.z = fmaxf(hi.z, s_box[5][w]);
  }
}

// (this warp's kept primitives of prim[base, base + 256) as a ballot, the
// slot of this thread's in the block's list, the block's count); every
// thread of the block calls it
struct Kept {
  bool keep;
  int slot, total;
};

__device__ __forceinline__ Kept compact(bool keep, int* s_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, keep);
  __syncthreads();  // the previous round's counts and list are read
  if (lane == 0) s_count[warp] = __popc(m);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? s_count[w] : 0;
    total += s_count[w];
  }
  return Kept{keep, off + __popc(m & ((1u << lane) - 1u)), total};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ψ over one brick a block. prim: (K, 2) float4, (c, α) | (coef, lmn bits)
__global__ void __launch_bounds__(kThreads) gto_psi_kernel(
    const float4* __restrict__ prim, int K, Grid g, int bricks_y,
    int bricks_z, float* __restrict__ out) {
  __shared__ float4 s_c[kThreads];
  __shared__ float2 s_k[kThreads];  // coef, lmn bits
  __shared__ float s_box[6][kWarps];
  __shared__ int s_count[kWarps];

  const int t = threadIdx.x;
  const Voxel v = brick_voxel<kBX, kBY, kBZ>(g, bricks_y, bricks_z, t);
  float3 lo, hi;
  brick_box(v, s_box, lo, hi);

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
    const Kept kept = compact(keep, s_count);  // after the previous list is read
    if (keep) {
      s_c[kept.slot] = c;
      s_k[kept.slot] = make_float2(e.x, e.y);
    }
    __syncthreads();
    if (v.active) {
      for (int j = 0; j < kept.total; ++j) {
        const float2 ck = s_k[j];
        psi = psi + phi(v.p, s_c[j], __float_as_int(ck.y)) * ck.x;
      }
    }
  }
  if (v.active) out[((size_t)v.ix * g.ny + v.iy) * g.nz + v.iz] = psi;
}

// ρ over one 4×4×4 brick a block (the design in the note at the head of
// the file). A, B: (K, M) row-major with M a multiple of 16; B is A when
// kTwo is false; w: (M,). Dynamic shared memory: the tiles, then the
// kept list (rho_launch).
template <bool kTwo>
struct RhoTiles {
  static constexpr int kCols = kTwo ? 8 : 16;   // a thread's columns of a product
  static constexpr int kQuads = kCols / 4;      // its 4-column groups
  static constexpr int kPass = 2 * kWarps * kCols;  // columns a pass
  // floats: the chunk's primitives (8 each), φ, the rows of A (and B)
  static constexpr int kPrim = kChunk * 8;
  static constexpr int kFloats =
      kPrim + kChunk * kRVox + (kTwo ? 2 : 1) * kChunk * kPass;
};

// the products of one chunk: nq of this thread's 4-column groups (at
// columns col[qd]) against its four voxels, primitive by primitive
template <int nq, bool kTwo, int kCols, int kPass>
__device__ __forceinline__ void contract(int kc, const float (*s_phi)[kRVox],
                                         const float (*s_a)[kPass],
                                         const float (*s_b)[kPass], int vg,
                                         const int* col,
                                         float (&acc_a)[4][kCols],
                                         float (&acc_b)[kTwo ? 4 : 1][kCols]) {
#pragma unroll 4
  for (int j = 0; j < kc; ++j) {
    const float4 p4 = reinterpret_cast<const float4*>(s_phi[j])[vg];
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
    float4 a4[nq], b4[nq];
#pragma unroll
    for (int qd = 0; qd < nq; ++qd) {
      a4[qd] = *reinterpret_cast<const float4*>(&s_a[j][col[qd]]);
      if (kTwo) b4[qd] = *reinterpret_cast<const float4*>(&s_b[j][col[qd]]);
    }
#pragma unroll
    for (int qd = 0; qd < nq; ++qd) {
      const float av[4] = {a4[qd].x, a4[qd].y, a4[qd].z, a4[qd].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_a[i][4 * qd + e] = __fmaf_rn(pv[i], av[e], acc_a[i][4 * qd + e]);
      }
      if (kTwo) {
        const float bv[4] = {b4[qd].x, b4[qd].y, b4[qd].z, b4[qd].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_b[kTwo ? i : 0][4 * qd + e] =
                __fmaf_rn(pv[i], bv[e], acc_b[kTwo ? i : 0][4 * qd + e]);
        }
      }
    }
  }
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads, 2) gto_rho_kernel(
    const float4* __restrict__ prim, int K, const float* __restrict__ A,
    const float* __restrict__ B, const float* __restrict__ w, int M, Grid g,
    int bricks_y, int bricks_z, float* __restrict__ out) {
  using T = RhoTiles<kTwo>;
  constexpr int kCols = T::kCols, kQuads = T::kQuads, kPass = T::kPass;
  constexpr int kSlots = 2 * kWarps;
  extern __shared__ __align__(16) float smem[];
  float4* s_pc = reinterpret_cast<float4*>(smem);  // the chunk's primitives
  // s_phi[primitive][voxel]; the pass's partial sums [slot][voxel] after it
  float(*s_phi)[kRVox] = reinterpret_cast<float(*)[kRVox]>(smem + T::kPrim);
  float(*s_a)[kPass] =
      reinterpret_cast<float(*)[kPass]>(smem + T::kPrim + kChunk * kRVox);
  float(*s_b)[kPass] = reinterpret_cast<float(*)[kPass]>(
      smem + T::kPrim + kChunk * kRVox + kChunk * kPass);
  unsigned short* s_list =  // kept primitives, ascending
      reinterpret_cast<unsigned short*>(smem + T::kFloats);
  __shared__ float s_box[6][kWarps];
  __shared__ int s_count[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int u = t & (kRVox - 1);  // this thread's voxel for φ and the output
  const int quarter = t / kRVox;  // its primitives of a chunk: ≡ quarter (mod 4)
  const int vg = lane & 15;       // its voxels of the contraction: 4·vg + i
  const int half = lane >> 4;
  const int slot = 2 * warp + half;  // its place in the pass's sums
  const Voxel v = brick_voxel<kRX, kRY, kRZ>(g, bricks_y, bricks_z, u);
  float3 lo, hi;
  brick_box(v, s_box, lo, hi);

  int n = 0;
  for (int base = 0; base < K; base += kThreads) {
    const int k = base + t;
    const Kept kept = compact(k < K && !skip(prim[2 * k], lo, hi), s_count);
    if (kept.keep) s_list[n + kept.slot] = (unsigned short)k;
    n += kept.total;
  }
  __syncthreads();  // the list is written
  const bool owner = t < kRVox && v.active;  // writes ρ of voxel u
  const size_t at = ((size_t)v.ix * g.ny + v.iy) * g.nz + v.iz;
  if (n == 0) {  // no primitive reaches the brick: ρ is exactly 0
    if (owner) out[at] = 0.0f;
    return;
  }

  // this thread's 4-column groups of a pass: 2·(warp + 8·qd) + half, so
  // the two halves of a warp hold the same count (M is a multiple of 16),
  // and a narrow pass still spreads over the warps
  int col[kQuads];
#pragma unroll
  for (int qd = 0; qd < kQuads; ++qd) col[qd] = 4 * (2 * (warp + kWarps * qd) + half);
  float rho = 0.0f;
  for (int c0 = 0; c0 < M; c0 += kPass) {
    const int cols = min(kPass, M - c0), segs = cols / 4;
    int nq = 0;  // this warp's groups inside the pass (warp-uniform)
#pragma unroll
    for (int qd = 0; qd < kQuads; ++qd) nq += 8 * (warp + kWarps * qd) < cols;
    float acc_a[4][kCols], acc_b[kTwo ? 4 : 1][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        acc_a[i][q] = 0.0f;
        if (kTwo) acc_b[kTwo ? i : 0][q] = 0.0f;
      }
    }
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      const int kc = min(kChunk, n - j0);
      // the chunk's primitives (one group), then its rows (another), in
      // flight while φ is evaluated
      if (t < 2 * kc) {
        const int k = s_list[j0 + (t >> 1)];
        cp_async16(&s_pc[t], prim + 2 * k + (t & 1));
      }
      cp_async_commit();
      for (int s = t; s < kc * segs; s += kThreads) {
        const int r = s / segs, q = s - r * segs;
        const size_t src = (size_t)s_list[j0 + r] * M + c0 + 4 * q;
        cp_async16(&s_a[r][4 * q], A + src);
        if (kTwo) cp_async16(&s_b[r][4 * q], B + src);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // the primitives are in
#pragma unroll
      for (int i = 0; i < kChunk / 4; ++i) {
        const int j = quarter + 4 * i;
        if (j < kc) {
          const float f = phi(v.p, s_pc[2 * j], __float_as_int(s_pc[2 * j + 1].y));
          s_phi[j][u] = v.active ? f : 0.0f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // φ and the rows are in
      switch (nq) {
        case 4:
          contract<(kQuads < 4 ? kQuads : 4), kTwo, kCols, kPass>(
              kc, s_phi, s_a, s_b, vg, col, acc_a, acc_b);
          break;
        case 3:
          contract<(kQuads < 3 ? kQuads : 3), kTwo, kCols, kPass>(
              kc, s_phi, s_a, s_b, vg, col, acc_a, acc_b);
          break;
        case 2:
          contract<2, kTwo, kCols, kPass>(kc, s_phi, s_a, s_b, vg, col, acc_a,
                                          acc_b);
          break;
        case 1:
          contract<1, kTwo, kCols, kPass>(kc, s_phi, s_a, s_b, vg, col, acc_a,
                                          acc_b);
          break;
        default:
          break;
      }
      __syncthreads();  // the chunk's tiles are read
    }
    // Σ_m w_m·(ΦA)_m·(ΦB)_m over this thread's columns, then over the
    // slots in order
    float(*s_red)[kRVox] = s_phi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part = 0.0f;
#pragma unroll
      for (int qd = 0; qd < kQuads; ++qd) {
        if (qd < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = acc_a[i][4 * qd + e];
            const float b = kTwo ? acc_b[kTwo ? i : 0][4 * qd + e] : a;
            part = part + a * b * w[c0 + col[qd] + e];
          }
        }
      }
      s_red[slot][4 * vg + i] = part;
    }
    __syncthreads();
    if (t < kRVox) {
      float sum = s_red[0][t];
#pragma unroll
      for (int j = 1; j < kSlots; ++j) sum = sum + s_red[j][t];
      rho = rho + sum;
    }
    __syncthreads();  // the partial sums are read
  }
  if (owner) out[at] = rho;
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

template <bool kTwo>
int rho_launch(const float* prim, int K, const float* A, const float* B,
               const float* w, int M, const Grid& g, int bricks_y,
               int bricks_z, unsigned blocks, float* out,
               cudaStream_t stream) {
  // the tiles (82 KB), then the kept list, 2 bytes a primitive
  const size_t bytes =
      RhoTiles<kTwo>::kFloats * sizeof(float) +
      (((size_t)K * sizeof(unsigned short) + 15) & ~(size_t)15);
  const cudaError_t e = cudaFuncSetAttribute(
      gto_rho_kernel<kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  gto_rho_kernel<kTwo><<<blocks, kThreads, bytes, stream>>>(
      (const float4*)prim, K, A, B, w, M, g, bricks_y, bricks_z, out);
  return (int)cudaGetLastError();
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

// ρ = Σ_m w_m·(ΦA)_m·(ΦB)_m; B null for the density (B = A). A and B are
// (K, M) row-major float32 with M a multiple of 16, w is (M,); K ≤ 65,535.
extern "C" int gto_rho_launch(const float* prim, int K, const float* A,
                              const float* B, const float* w, int M,
                              const float* gp, int oriented, int nx, int ny,
                              int nz, float* out, void* stream) {
  if (K < 0 || K > 65535 || M < 0 || M % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Grid g = make_grid(gp, oriented, nx, ny, nz);
  const int by = (ny + kRY - 1) / kRY, bz = (nz + kRZ - 1) / kRZ;
  const unsigned blocks =
      (unsigned)((long long)((nx + kRX - 1) / kRX) * by * bz);
  if (B == nullptr)
    return rho_launch<false>(prim, K, A, nullptr, w, M, g, by, bz, blocks, out,
                             (cudaStream_t)stream);
  return rho_launch<true>(prim, K, A, B, w, M, g, by, bz, blocks, out,
                          (cudaStream_t)stream);
}
