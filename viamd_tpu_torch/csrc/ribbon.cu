// Ribbon and cartoon meshes of the protein backbone, built on the card and
// written straight into view space, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds this mesh on the host in
// numpy (viamd_tpu/render/ribbon_mesh.py), and so does the port's plain
// version, render/ribbon_mesh.py::ribbon_mesh, followed by render/
// triangles.py::view_transform. On a 1,066,628-atom capsid of 60 chains
// that host routine took ~760 ms a frame and its 21.8 MB of triangles were
// then copied to the card; here the world-space mesh never exists, and the
// triangles land in the (T, 3, 3) float32 tensor the triangle raster takes.
//
// What it computes, per chain of k >= 2 backbone residues (m = (k - 1) *
// subdiv + 1 spline samples), exactly as the plain version does:
//   residues: P = the CA positions (float64); co = O - C in float32;
//        tan = unit(gradient(P)); od = unit(co - tan (co . tan)), its sign
//        flipped where od_i . od_{i-1} < 0 (a scan along the chain);
//        width and thickness from the (coil, helix, sheet) weights, or the
//        constant flat section in ribbons mode
//   samples: S = Catmull-Rom(P), O = unit(Catmull-Rom(od)), the last
//        sample the last control point itself; tan = unit(gradient(S));
//        width and thickness interpolated at u = j / subdiv, the sheet
//        arrowheads over u in [i - 0.5, i + 1e-9]; wdir = unit(O - tan
//        (O . tan)), ndir = unit(tan x wdir); four corners S +- wdir w/2
//        +- ndir t/2
//   triangles: per chain 8 face groups of m - 1 (the quad strip between
//        consecutive samples), then two start caps and two end caps, in
//        the plain version's order, which the raster's ties depend on
//   output: each corner cast to float32, then the view product in float32
//        ((x m0 + y m1) + z m2) + m3
//
// Every operation is numpy's, in numpy's order, in float64 (the norm sums
// (x^2 + y^2) + z^2, np.gradient halves central differences and takes
// plain ones at the ends, np.linspace's t is q * (1 / subdiv), np.cross is
// a1 b2 - a2 b1, ...), with IEEE division and square root, and the library
// is built with -fmad=false, so the triangles equal the plain version's bit
// for bit. One exception cannot matter: the flip test's dot product sums
// left to right, where numpy's np.dot may go through BLAS in another order;
// only its sign is read, and that differs only for od vectors
// perpendicular to within rounding.
//
// What bounds it on the H100: the 21.8 MB of triangles it writes at the
// capsid frame (~6.5 us at 3.35 TB/s) and ~25 MFLOP of float64 (~0.4 us at
// 67 TFLOP/s), so it is bound by its launch. The design: one block a chain.
// The block first computes its residues' peptide-plane directions, widths
// and thicknesses into a float64 scratch row each (any chain length fits),
// then one thread runs the flip scan, then the block walks the chain's
// samples kThreads - 1 segments at a time: a thread a sample computes its
// four view-space corners into shared memory (the spline at a sample's
// neighbours recomputed from the control points, not stored), and a
// thread a segment writes its eight triangles, consecutive threads to
// consecutive triangles of each face group.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWork = 5;  // scratch doubles a residue: od (3), width, thickness

struct Params {
  float view[12];  // rows 0-2 of the view matrix, row-major
  int subdiv;
  int cartoon;  // 1: widths by secondary structure, arrowheads; 0: ribbons
  int has_ss;   // 0: every residue coil
  double coil_width, coil_thickness, ribbon_width, ribbon_thickness;
  double arrow_scale, width_scale;
};

struct V3 {
  double x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ double dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// v / max(|v|, 1e-12): np.linalg.norm's sum, np.maximum (NaN kept)
__device__ __forceinline__ V3 unit(V3 v) {
  double n = sqrt(dot(v, v));
  n = n < 1e-12 ? 1e-12 : n;
  return {v.x / n, v.y / n, v.z / n};
}

// One coordinate of the Catmull-Rom segment through p0..p3 at t, in the
// plain version's order of operations.
__device__ __forceinline__ double catmull_rom(double p0, double p1, double p2, double p3,
                                              double t) {
  const double a = 2.0 * p1;
  const double b = (-p0 + p2) * t;
  const double c = (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t * t;
  const double d = (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t * t * t;
  return 0.5 * (a + b + c + d);
}

// Sample j of the spline through a chain's k control points ctrl(0..k-1):
// the end points padded by reflection, t = q * (1 / subdiv), and the last
// sample the last control point.
template <class F>
__device__ V3 spline_at(const F& ctrl, int k, int j, int subdiv, double step) {
  if (j == (k - 1) * subdiv) return ctrl(k - 1);
  const int s = j / subdiv;
  const double t = (double)(j - s * subdiv) * step;
  const V3 p1 = ctrl(s);
  const V3 p2 = ctrl(s + 1);
  const V3 p0 = s == 0 ? sub(mul(p1, 2.0), p2) : ctrl(s - 1);
  const V3 p3 = s + 2 >= k ? sub(mul(p2, 2.0), p1) : ctrl(s + 2);
  return {catmull_rom(p0.x, p1.x, p2.x, p3.x, t), catmull_rom(p0.y, p1.y, p2.y, p3.y, t),
          catmull_rom(p0.z, p1.z, p2.z, p3.z, t)};
}

// np.gradient of samples f(0..n-1) at i: plain differences at the ends,
// halved central ones inside.
template <class F>
__device__ __forceinline__ V3 gradient_at(const F& f, int n, int i) {
  if (i == 0) return sub(f(1), f(0));
  if (i == n - 1) return sub(f(n - 1), f(n - 2));
  const V3 d = sub(f(i + 1), f(i - 1));
  return {d.x / 2.0, d.y / 2.0, d.z / 2.0};
}

__device__ __forceinline__ void to_view(const float* m, V3 c, float* out) {
  const float x = (float)c.x, y = (float)c.y, z = (float)c.z;
  for (int r = 0; r < 3; ++r) {
    out[r] = x * m[4 * r] + y * m[4 * r + 1] + z * m[4 * r + 2] + m[4 * r + 3];
  }
}

__device__ __forceinline__ void put(float* dst, const float* a, const float* b, const float* c) {
  for (int i = 0; i < 3; ++i) {
    dst[i] = a[i];
    dst[3 + i] = b[i];
    dst[6 + i] = c[i];
  }
}

__global__ void __launch_bounds__(kThreads) ribbon_kernel(
    const float* __restrict__ coords,  // (N, 3) atom positions
    const int* __restrict__ atom_ca,   // (nbb) CA atom of each backbone residue
    const int* __restrict__ atom_c,    // (nbb) C atom
    const int* __restrict__ atom_o,    // (nbb) O atom
    const float* __restrict__ ss,      // (nbb, 3) coil/helix/sheet weights, or null
    const int* __restrict__ chains,    // (chains, 3) first residue, residues, first triangle
    Params p,
    double* work,                      // (nbb, kWork) scratch
    float* __restrict__ out) {         // (T, 3, 3) view-space triangles
  __shared__ float corner[kThreads][12];  // a tile's samples: 4 view-space corners each

  const int beg = chains[3 * blockIdx.x];
  const int k = chains[3 * blockIdx.x + 1];
  float* const tri = out + 9 * (size_t)chains[3 * blockIdx.x + 2];
  const int m = (k - 1) * p.subdiv + 1;
  const int nseg = m - 1;
  const double step = 1.0 / (double)p.subdiv;
  double* const w = work + (size_t)kWork * beg;

  const auto ca = [&](int i) {
    const float* x = coords + 3 * (size_t)atom_ca[beg + i];
    return V3{(double)x[0], (double)x[1], (double)x[2]};
  };
  const auto od = [&](int i) { return V3{w[kWork * i], w[kWork * i + 1], w[kWork * i + 2]}; };
  const auto sheet = [&](int i) {
    return p.has_ss && (double)ss[3 * (size_t)(beg + i) + 2] > 0.5;
  };

  // residues: peptide-plane direction, width and thickness
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int r = beg + i;
    const float* xo = coords + 3 * (size_t)atom_o[r];
    const float* xc = coords + 3 * (size_t)atom_c[r];
    const V3 co{(double)(xo[0] - xc[0]), (double)(xo[1] - xc[1]), (double)(xo[2] - xc[2])};
    const V3 tan = unit(gradient_at(ca, k, i));
    const V3 o = unit(sub(co, mul(tan, dot(co, tan))));
    double wr = p.ribbon_width, tr = p.ribbon_thickness;
    if (p.cartoon) {
      const double flat =
          p.has_ss ? (double)ss[3 * (size_t)r + 1] + (double)ss[3 * (size_t)r + 2] : 0.0;
      wr = p.coil_width + (p.ribbon_width - p.coil_width) * flat;
      tr = p.coil_thickness + (p.ribbon_thickness - p.coil_thickness) * flat;
    }
    double* const wi = w + kWork * i;
    wi[0] = o.x;
    wi[1] = o.y;
    wi[2] = o.z;
    wi[3] = wr;
    wi[4] = tr;
  }
  __syncthreads();

  // the flip correction, in chain order
  if (threadIdx.x == 0) {
    V3 prev = od(0);
    for (int i = 1; i < k; ++i) {
      V3 cur = od(i);
      if (dot(cur, prev) < 0.0) {
        cur = V3{-cur.x, -cur.y, -cur.z};
        w[kWork * i] = cur.x;
        w[kWork * i + 1] = cur.y;
        w[kWork * i + 2] = cur.z;
      }
      prev = cur;
    }
  }
  __syncthreads();

  const auto S = [&](int j) { return spline_at(ca, k, j, p.subdiv, step); };
  for (int j0 = 0; j0 < nseg; j0 += kThreads - 1) {
    const int j = j0 + threadIdx.x;
    float* const mine = corner[threadIdx.x];
    if (j < m) {
      const V3 s = S(j);
      const V3 tan = unit(gradient_at(S, m, j));
      const V3 o = unit(spline_at(od, k, j, p.subdiv, step));

      // width and thickness at u = j / subdiv
      const double u = (double)j / (double)p.subdiv;
      const int ut = (int)u;
      const int ui = ut < k - 1 ? ut : k - 1;
      const double uf = u - (double)ui;
      const int nx = ui + 1 < k - 1 ? ui + 1 : k - 1;
      double ws = w[kWork * ui + 3] * (1 - uf) + w[kWork * nx + 3] * uf;
      double ts = w[kWork * ui + 4] * (1 - uf) + w[kWork * nx + 4] * uf;
      if (p.cartoon) {
        // the arrowhead of a sheet run's last residue i >= 1, over
        // u in [i - 0.5, i + 1e-9]: only i = ut or ut + 1 can hold u
        for (int i = ut; i <= ut + 1; ++i) {
          if (i >= 1 && i < k && sheet(i) && (i + 1 >= k || !sheet(i + 1)) &&
              u >= (double)i - 0.5 && u <= (double)i + 1e-9) {
            const double f = (u - ((double)i - 0.5)) / 0.5;
            const double g = 1.0 - f;
            ws = w[kWork * i + 3] * p.arrow_scale * (g < 0.02 ? 0.02 : g);
          }
        }
      }
      ws = ws * p.width_scale;
      ts = ts * p.width_scale;

      const V3 wdir = unit(sub(o, mul(tan, dot(o, tan))));
      const V3 ndir = unit(V3{tan.y * wdir.z - tan.z * wdir.y, tan.z * wdir.x - tan.x * wdir.z,
                              tan.x * wdir.y - tan.y * wdir.x});
      const V3 wv = mul(wdir, ws * 0.5);
      const V3 nv = mul(ndir, ts * 0.5);
      to_view(p.view, add(add(s, wv), nv), mine);
      to_view(p.view, add(sub(s, wv), nv), mine + 3);
      to_view(p.view, sub(sub(s, wv), nv), mine + 6);
      to_view(p.view, sub(add(s, wv), nv), mine + 9);
      // end caps, after the 8 face groups
      if (j == 0) {
        put(tri + 9 * (size_t)(8 * nseg), mine, mine + 3, mine + 6);
        put(tri + 9 * (size_t)(8 * nseg + 1), mine, mine + 6, mine + 9);
      }
      if (j == m - 1) {
        put(tri + 9 * (size_t)(8 * nseg + 2), mine, mine + 6, mine + 3);
        put(tri + 9 * (size_t)(8 * nseg + 3), mine, mine + 9, mine + 6);
      }
    }
    __syncthreads();
    if (threadIdx.x < kThreads - 1 && j < nseg) {
      const float* a = mine;
      const float* b = corner[threadIdx.x + 1];
      for (int f = 0; f < 4; ++f) {
        const int g = (f + 1) % 4;
        put(tri + 9 * ((size_t)(2 * f) * nseg + j), a + 3 * f, b + 3 * f, b + 3 * g);
        put(tri + 9 * ((size_t)(2 * f + 1) * nseg + j), a + 3 * f, b + 3 * g, a + 3 * g);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one block per chain on `stream`. `view` is a host pointer to the
// view matrix's first three rows (12 floats). Returns cudaGetLastError()
// right after the launch.
extern "C" int ribbon_launch(const float* coords, const int* atom_ca, const int* atom_c,
                             const int* atom_o, const float* ss, const int* chains, int n_chains,
                             const float* view, int subdiv, int cartoon, double coil_width,
                             double coil_thickness, double ribbon_width, double ribbon_thickness,
                             double arrow_scale, double width_scale, double* work, float* out,
                             void* stream) {
  Params p;
  for (int i = 0; i < 12; ++i) p.view[i] = view[i];
  p.subdiv = subdiv;
  p.cartoon = cartoon;
  p.has_ss = ss != nullptr;
  p.coil_width = coil_width;
  p.coil_thickness = coil_thickness;
  p.ribbon_width = ribbon_width;
  p.ribbon_thickness = ribbon_thickness;
  p.arrow_scale = arrow_scale;
  p.width_scale = width_scale;
  ribbon_kernel<<<n_chains, kThreads, 0, (cudaStream_t)stream>>>(coords, atom_ca, atom_c, atom_o,
                                                                 ss, chains, p, work, out);
  return (int)cudaGetLastError();
}
