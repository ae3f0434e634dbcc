// Cell-list pair-distance histogram for the RDF, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel viamd_tpu/ops/pallas_rdf.py::_hist_kernel (and the
// plane/tile preparation around it in _pair_dist_histogram_impl). It counts
// A→B minimum-image distances below r_max into nbins equal bins:
//
//   for every A atom i (in its cell c), every B atom j of the cells of the
//   stencil around c (periodic wrap):
//     skip i == j by global id;
//     d = min_image(x_i − x_j)   (single fractional round, ops/pbc.py)
//     if |d| < r_max: hist[int(|d| · nbins / r_max)] += 1
//
// The stencil reaches `radius` cells each way (1 or 2, as the TPU kernel's
// `radius`): (2·radius + 1)³ cells, 27 or 125. Cells are at least
// r_max / radius wide, so every pair within r_max lies in it. Two walks, as
// ops/cuda_rdf.py::pair_hist_cells_plain repeats them:
//   * A ≠ B (two cell lists): the full stencil, ordered pairs, the
//     global-id test.
//   * symmetric (one cell list for both sides, A == B): the self cell with
//     pairs (i, j), j > i in the cell's CSR order, plus the 13 (62) "upper"
//     offsets (ops/rdf.py::stencil_offsets(radius, symmetric=True)[1:], the
//     TPU kernel's half stencil) with all pairs. Each unordered pair is
//     counted once in shared memory and the block's merge adds twice each
//     bin.
//     Why that equals the all-pairs plain version (which counts (i, j) and
//     (j, i)) bit for bit: swapping i and j negates every component of d
//     exactly; products and sums of negated operands round to the negated
//     result (round to nearest even is symmetric), and rintf(−f) = −rintf(f);
//     so the squared distance of (j, i) has the bits of that of (i, j). With
//     min(dims) >= 2·radius + 1 (the wrapper requires it) the offsets reach
//     distinct cells, so each unordered cell pair is visited exactly once:
//     from the cell for which its offset is the upper one of ±o.
//
// Every pair counts: the cell lists are CSR (sorted order + cell_start), so
// there are no per-cell capacities and nothing is dropped. Coordinates are
// read as given (unwrapped); the cell ids were computed from wrapped
// positions by the caller, and the min-image makes distances independent of
// the stored image. The arithmetic is the plain version's
// (ops/rdf.py::min_image_sq), operation for operation, built with
// -fmad=false, on every path that reaches a bin.
//
// What bounds it on the H100, and what the design does about it. At the
// headline (33,334 O atoms in a 100 Å box, 10x10x10 cells of ~33 atoms,
// r_max 10 Å, 128 bins) the symmetric walk tests 15.26 M unordered
// candidates, of which 2.44 M are in range. The inputs are ~0.4 MB, so the
// bound is the arithmetic: ~22 f32 operations per candidate, 0.005 ms at
// the card's 67 TFLOP/s. What the kernel costs is the instructions it
// runs per candidate, so the design keeps everything but the distance
// out of the pair loop:
//   * half the candidates: the half stencil above (the previous design
//     walked all 27 cells and counted ordered pairs, 30.6 M candidates);
//   * no block-wide barrier and no division in the pair loop: a block owns
//     one A cell and one contiguous part of the concatenation of its
//     stencil cells, which it stages once into shared memory (float4 x, y,
//     z, id; one barrier; chunks of 1,024 atoms beyond that). A slice of
//     rows = ceil(na / kAtoms) threads holds the cell's A atoms in
//     registers, kAtoms (2) to a thread (atoms r and r + rows); the
//     threads / rows slices walk the B positions with that stride, so each
//     B atom is loaded once for two candidates. At 33 atoms a cell that is
//     15 slices of 17 threads, 255 of 256 lanes busy, where one lane per A
//     atom would leave most lanes of a second pass idle. A cell's A atoms
//     go in chunks of kChunk (256), so a slice is at most half the block:
//     the ~267 O a cell of a radius-2 grid at the headline density take a
//     chunk of 256 on 2 slices and one of 11 on 42, where one chunk of 267
//     would walk every B position on 134 threads and idle the rest.
//     Divisions happen once per thread;
//   * the grid is ncells x parts blocks, parts chosen at launch so the card
//     holds the blocks at least kWaves times over, which keeps the SMs fed
//     to the end of the walk;
//   * an orthorhombic branch, taken when every off-diagonal entry of basis
//     and inv_basis is exactly 0 and the box is periodic (a block-uniform
//     test inside the kernel, no host sync): f = d·I_kk; f −= rint(f);
//     o = f·B_kk per axis, 15 operations where the general 3x3 form takes
//     33. The terms it skips are exact ±0 additions and the sign of a zero
//     vanishes in the square, so |o|² keeps its bits;
//   * a conservative reject before the sqrt: a candidate with |o|² > s_hi
//     is out of range without one. s_hi (ops/cuda_rdf.py::sqrt_reject_bound,
//     computed on the host in float64) is the largest float32 whose
//     correctly rounded sqrt is below r_max, so no bin changes;
//   * per-warp histograms in dynamic shared memory (nbins int32 each, sized
//     at launch), so lanes of different warps never contend for a bin of
//     water's sharp first peak; merged once per block with one global
//     atomicAdd per non-empty bin.
// What remains is the instruction stream: per candidate the 15 operations
// of d and the min-image and the 5 of |o|², three of them rints at a
// quarter of the f32 rate; and the sqrt, the bin and the shared atomic of
// an in-range candidate, which the whole warp steps through whenever any
// of the 64 candidates of its step is in range: at 1 in 6, nearly always.
//
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks an SM must hold: 64 registers a thread
constexpr int kWaves = 2;      // blocks launched per block the card holds at once
constexpr int kAtoms = 2;      // A atoms a thread holds
constexpr int kChunk = kAtoms * kThreads / 2;  // A atoms a pass: 2+ slices
constexpr int kStage = 1024;  // B atoms staged per pass, one float4 each
constexpr int kMaxBins = 4096;
constexpr int kMaxRadius = 2;
constexpr int kMaxSeg = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1) *
                        (2 * kMaxRadius + 1);  // stencil cells, 125
// dynamic shared memory a block may take on sm_90: 227 KB less the static
// arrays (the staging buffer and the stencil table)
constexpr int kMaxSmem = 232448 - kStage * 16 - (2 * kMaxSeg + 1) * 4;
constexpr int kMaxParts = 16;
static_assert(kWarps * 4 * kMaxBins <= kMaxSmem,
              "a histogram per warp must fit at the most bins");

// Shared memory of a block: the staged B atoms (x, y, z, id as float bits),
// the stencil cells' first atoms and offsets in the concatenation, and, in
// dynamic shared memory, one histogram of nbins int32 per warp.
__shared__ float4 g_stage[kStage];
__shared__ int g_seg_start[kMaxSeg];
__shared__ int g_seg_off[kMaxSeg + 1];
extern __shared__ int g_hist[];

// |min_image(d)|², in the plain version's order of operations.
template <bool kOrtho>
__device__ __forceinline__ float min_image_sq(float d0, float d1, float d2,
                                              const float (&B)[9],
                                              const float (&I)[9], float keep) {
  if (kOrtho) {
    float f0 = d0 * I[0];
    float f1 = d1 * I[4];
    float f2 = d2 * I[8];
    f0 = f0 - rintf(f0);
    f1 = f1 - rintf(f1);
    f2 = f2 - rintf(f2);
    const float o0 = f0 * B[0];
    const float o1 = f1 * B[4];
    const float o2 = f2 * B[8];
    return o0 * o0 + o1 * o1 + o2 * o2;
  }
  float f0 = d0 * I[0] + d1 * I[3] + d2 * I[6];
  float f1 = d0 * I[1] + d1 * I[4] + d2 * I[7];
  float f2 = d0 * I[2] + d1 * I[5] + d2 * I[8];
  f0 = f0 - rintf(f0);  // round half to even, as torch/jnp.round
  f1 = f1 - rintf(f1);
  f2 = f2 - rintf(f2);
  const float o0 = f0 * B[0] + f1 * B[3] + f2 * B[6] + d0 * keep;
  const float o1 = f0 * B[1] + f1 * B[4] + f2 * B[7] + d1 * keep;
  const float o2 = f0 * B[2] + f1 * B[5] + f2 * B[8] + d2 * keep;
  return o0 * o0 + o1 * o1 + o2 * o2;
}

// A candidate past the reject → its bin in the per-warp histogram `wh`.
__device__ __forceinline__ void bin_pair(float s, int* wh, int nbins,
                                         float r_max, float inv_bin) {
  const float dist = sqrtf(s);
  if (dist < r_max) {
    const int bin = (int)(dist * inv_bin);
    if (bin < nbins) atomicAdd(&wh[bin], 1);
  }
}

// One B atom against the thread's kAtoms A atoms; each pair whose |o|² is
// not past the reject goes to the histogram. kSelf: j lies in the self
// cell, where atom k pairs only with j > il[k].
template <bool kOrtho, bool kSym, bool kSelf>
__device__ __forceinline__ void pair_step(
    int j, float4 b, const float (&ax)[kAtoms], const float (&ay)[kAtoms],
    const float (&az)[kAtoms], const int (&aid)[kAtoms],
    const int (&il)[kAtoms], const float (&B)[9], const float (&I)[9],
    float keep, float s_hi, int* wh, int nbins, float r_max, float inv_bin) {
  float s[kAtoms];
#pragma unroll
  for (int k = 0; k < kAtoms; ++k)
    s[k] = min_image_sq<kOrtho>(ax[k] - b.x, ay[k] - b.y, az[k] - b.z, B, I,
                                keep);
#pragma unroll
  for (int k = 0; k < kAtoms; ++k) {
    const bool pair =
        kSym ? (!kSelf || j > il[k]) : __float_as_int(b.w) != aid[k];
    if (pair && s[k] <= s_hi) bin_pair(s[k], wh, nbins, r_max, inv_bin);
  }
}

// One block's walk: the A atoms of its cell, kAtoms to a thread, against
// positions [pb, pe) of the concatenated stencil cells.
template <bool kOrtho, bool kSym>
__device__ __forceinline__ void walk(
    const float* __restrict__ xa, const int* __restrict__ ida, int a0, int na,
    const float* __restrict__ xb, const int* __restrict__ idb, int nseg,
    int pb, int pe, int* wh, const float (&B)[9], const float (&I)[9],
    float keep, int nbins, float r_max, float inv_bin, float s_hi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float nan = __int_as_float(0x7fc00000);
  for (int ac = 0; ac < na; ac += kChunk) {
    // a slice is `rows` threads holding the chunk's atoms r, r + rows, ...;
    // slices walk the B positions with stride `slices`
    const int nac = min(kChunk, na - ac);
    const int rows = (nac + kAtoms - 1) / kAtoms;
    const int slices = kThreads / rows;
    const int slice = tid / rows;
    const int r = tid - slice * rows;
    const bool active = slice < slices;
    float ax[kAtoms], ay[kAtoms], az[kAtoms];
    int aid[kAtoms], il[kAtoms];
#pragma unroll
    for (int k = 0; k < kAtoms; ++k) {
      const int i = r + k * rows;
      il[k] = ac + i;  // the atom's index in its cell
      aid[k] = -1;
      ax[k] = ay[k] = az[k] = nan;  // no atom: its |o|² is NaN, never binned
      if (active && i < nac) {
        const int g = a0 + ac + i;
        ax[k] = xa[3 * g + 0];
        ay[k] = xa[3 * g + 1];
        az[k] = xa[3 * g + 2];
        aid[k] = ida[g];
      }
    }
    int j = pe;
    if (active) {
      j = pb + slice;
      // the self cell is segment 0, in A's own order: its pairs need
      // j > il, and il[0] is the thread's smallest
      if (kSym && j <= il[0]) j += ((il[0] - j) / slices + 1) * slices;
    }
    for (int cb = pb; cb < pe; cb += kStage) {
      const int ce = min(cb + kStage, pe);
      __syncthreads();  // the previous chunk is consumed
      for (int l = warp; l < nseg; l += kWarps) {
        const int lo = max(g_seg_off[l], cb), hi = min(g_seg_off[l + 1], ce);
        const int src0 = g_seg_start[l] - g_seg_off[l];
        for (int p = lo + lane; p < hi; p += 32) {
          const int src = src0 + p;
          g_stage[p - cb] = make_float4(xb[3 * src + 0], xb[3 * src + 1],
                                        xb[3 * src + 2], __int_as_float(idb[src]));
        }
      }
      __syncthreads();
      const int self_end = kSym ? min(ce, na) : cb;
      for (; j < self_end; j += slices)
        pair_step<kOrtho, kSym, true>(j, g_stage[j - cb], ax, ay, az, aid, il,
                                      B, I, keep, s_hi, wh, nbins, r_max, inv_bin);
      for (; j < ce; j += slices)
        pair_step<kOrtho, kSym, false>(j, g_stage[j - cb], ax, ay, az, aid, il,
                                       B, I, keep, s_hi, wh, nbins, r_max, inv_bin);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pair_hist_kernel(const float* __restrict__ xa, const int* __restrict__ ida,
                     const int* __restrict__ a_start,
                     const float* __restrict__ xb, const int* __restrict__ idb,
                     const int* __restrict__ b_start,
                     const float* __restrict__ basis,
                     const float* __restrict__ inv_basis, int dx, int dy,
                     int dz, int nbins, int symmetric, int radius,
                     float r_max, float inv_bin, float s_hi, int row_lo,
                     int* __restrict__ hist) {
  // the block's A cell: the window's cells follow row_lo's first (x-major)
  const int cell = row_lo * dy * dz + blockIdx.x;
  const int a0 = a_start[cell];
  const int na = a_start[cell + 1] - a0;
  if (na == 0) return;  // uniform across the block

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < kWarps * nbins; b += kThreads) g_hist[b] = 0;

  // offset o of the stencil is (o / w² − radius, o / w % w − radius,
  // o % w − radius); the centre (self) is o = nst / 2, and o > nst / 2 are
  // the lexicographically upper offsets
  const int w = 2 * radius + 1, nst = w * w * w, centre = nst / 2;
  const int nseg = symmetric ? centre + 1 : nst;
  if (warp == 0) {
    const int cz = cell % dz;
    const int cy = (cell / dz) % dy;
    const int cx = cell / (dz * dy);
    int carry = 0;
    for (int l0 = 0; l0 < nseg; l0 += 32) {
      const int l = l0 + lane;
      int start = 0, cnt = 0;
      if (l < nseg) {
        // self cell first, then the upper offsets, then the lower ones
        const int o = (l + centre) % nst;
        const int nx = (cx + o / (w * w) - radius + dx) % dx;
        const int ny = (cy + (o / w) % w - radius + dy) % dy;
        const int nz = (cz + o % w - radius + dz) % dz;
        const int nc = (nx * dy + ny) * dz + nz;
        start = b_start[nc];
        cnt = b_start[nc + 1] - start;
      }
      int inc = cnt;  // inclusive scan of the counts over the warp
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, k);
        if (lane >= k) inc += v;
      }
      if (l < nseg) {
        g_seg_start[l] = start;
        g_seg_off[l + 1] = carry + inc;
      }
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) g_seg_off[0] = 0;
  }

  // basis / inverse basis, row-major (3, 3): row i = lattice vector i
  float B[9], I[9];
  bool periodic = false, diagonal = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    B[k] = basis[k];
    I[k] = inv_basis[k];
    periodic = periodic || (B[k] != 0.0f);
    if (k % 4 != 0) diagonal = diagonal && B[k] == 0.0f && I[k] == 0.0f;
  }
  const float keep = periodic ? 0.0f : 1.0f;  // 1 − pbc_mask(basis)
  __syncthreads();

  // this block's part of the concatenated stencil cells
  const int nbt = g_seg_off[nseg];
  const int pb = (int)((long long)nbt * blockIdx.y / gridDim.y);
  const int pe = (int)((long long)nbt * (blockIdx.y + 1) / gridDim.y);
  if (pb == pe) return;  // uniform across the block
  int* wh = g_hist + warp * nbins;
#define PAIR_HIST_WALK(ORTHO, SYM)                                         \
  walk<ORTHO, SYM>(xa, ida, a0, na, xb, idb, nseg, pb, pe, wh, B, I, keep, \
                   nbins, r_max, inv_bin, s_hi)
  if (periodic && diagonal) {
    if (symmetric) PAIR_HIST_WALK(true, true);
    else PAIR_HIST_WALK(true, false);
  } else {
    if (symmetric) PAIR_HIST_WALK(false, true);
    else PAIR_HIST_WALK(false, false);
  }
#undef PAIR_HIST_WALK
  __syncthreads();
  for (int b = tid; b < nbins; b += kThreads) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += g_hist[w * nbins + b];
    if (v) atomicAdd(&hist[b], symmetric ? 2 * v : v);
  }
}

}  // namespace

extern "C" int pair_hist_max_bins() { return kMaxBins; }

// Launches on `stream`; adds into `hist` (nbins int32, zeroed by the
// caller). `symmetric`: xb/idb/b_start are the A cell list itself (the half
// stencil). `radius`: 1 or 2, with every dim at least 2·radius + 1.
// [row_lo, row_hi): the window of the leading cell axis whose cells are A
// cells (0, dx for the whole grid); B stays the whole cell list, read by
// index. Each candidate pair belongs to exactly one A cell in both walks, so
// the histograms of any partition of the rows sum to the whole grid's: a
// device mesh splits the rows over the ranks of its atoms axis
// (ops/cuda_rdf.py::pair_dist_histogram_cl_sharded, the counterpart of the
// TPU kernel's slab-sharded mode, pallas_rdf.py::pair_dist_histogram_pl_sharded).
// Returns cudaGetLastError() right after the launch, or an error without
// launching.
extern "C" int pair_hist_launch(const float* xa, const int* ida,
                                const int* a_start, const float* xb,
                                const int* idb, const int* b_start,
                                const float* basis, const float* inv_basis,
                                int dx, int dy, int dz, int nbins,
                                float r_max, float inv_bin, float s_hi,
                                int symmetric, int radius, int row_lo,
                                int row_hi, int* hist, void* stream) {
  const int w = 2 * radius + 1;
  if (nbins < 1 || nbins > kMaxBins || (symmetric && xb != xa) ||
      radius < 1 || radius > kMaxRadius || dx < w || dy < w || dz < w ||
      row_lo < 0 || row_hi > dx || row_lo >= row_hi)
    return (int)cudaErrorInvalidValue;
  const int smem_bytes = kWarps * 4 * nbins;
  // how many blocks the current device holds at once. Asked on every launch
  // (host-side queries, no sync), so each device gets its own answer; the
  // attribute is set to the most any launch takes, so concurrent launches
  // with different nbins never undercut each other.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      pair_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWarps * 4 * kMaxBins);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pair_hist_kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the window's cells: a slab of rows fills the card as the grid does
  const int ncells = (row_hi - row_lo) * dy * dz;
  int parts = (kWaves * sms * per_sm + ncells - 1) / ncells;
  parts = parts < 1 ? 1 : (parts > kMaxParts ? kMaxParts : parts);
  const dim3 grid(ncells, parts);
  pair_hist_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      xa, ida, a_start, xb, idb, b_start, basis, inv_basis, dx, dy, dz, nbins,
      symmetric, radius, r_max, inv_bin, s_hi, row_lo, hist);
  return (int)cudaGetLastError();
}
