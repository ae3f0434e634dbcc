// Per-atom colours of one representation, built on the card, hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package colours atoms on the host in numpy
// (viamd_tpu/render/color.py), and so did the port's Session, every frame,
// over every atom. On a 1,066,628-atom capsid that host chain took ~150 ms a
// frame and its 16 MB of colours then crossed the bus; here the inputs are
// device tables the session uploads only when what they come from changes,
// and the colours land where the rasters read them.
//
// What it computes, per output atom i (atom a = subset[i], or i), in the
// order of render/cuda_colors.py::colors_plain, its plain version:
//   1. the base colour: table[a]; or, with no table, the blend of the
//      secondary-structure weights of a's backbone residue k = bbres[a],
//      ((w0 s0 + w1 s1) + w2 s2) by channel, the coil colour s0 where k < 0
//   2. tint (when on): rgb = f32(double(rgb * keep) + add), add = tint *
//      scale in float64, as numpy adds a float32 product to a float64 one
//   3. saturation (when on): rgb = rgb * keep + lum * amount, lum =
//      (r l0 + g l1) + b l2
//   4. the filter: alpha 0 where the mask's bit is clear
//   5. the selection: where its bit is clear, desaturate as in 3
//   6. the radii (when asked): radius[a] where alpha > 0, else 0
// The mask and the selection are packed 32-bit words, bit a of word a / 32.
// Every operation is float32 but the tint's sum, and the library is built
// with -fmad=false, so the output equals the plain version's bit for bit.
//
// What bounds it on the H100: its bytes. A whole-system launch with radii
// reads a 16 B colour and a 4 B radius and writes 16 + 4 B an atom, plus
// the two bits (~40 B; ~44 B with the secondary-structure gather), so ~47
// MB and ~14 us at 1M atoms and 3.35 TB/s; a subset of the capsid's 9,540
// CA atoms is bound by its launch. The design: one thread an output atom,
// 16-byte loads and stores of the colours.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  int n;             // atoms written
  float ss[12];      // coil, helix, sheet colours (rgba rows)
  float lum[3];      // luminance weights
  int tint;          // 0: no tint
  float tint_keep;   // f32(1 - scale)
  double tint_add[3];
  int sat;           // 0: no per-representation saturation
  float sat_keep, sat_amount;
  float sel_keep, sel_amount;
};

__device__ __forceinline__ bool bit(const unsigned* words, int a) {
  return (__ldg(words + (a >> 5)) >> (a & 31)) & 1u;
}

__device__ __forceinline__ void desaturate(float& r, float& g, float& b, float keep, float amount,
                                           const float* l) {
  const float y = (r * l[0] + g * l[1]) + b * l[2];
  r = r * keep + y * amount;
  g = g * keep + y * amount;
  b = b * keep + y * amount;
}

__global__ void __launch_bounds__(kThreads)
    colors_kernel(const float4* __restrict__ table, const float* __restrict__ ss,
                  const int* __restrict__ bbres, const unsigned* __restrict__ mask,
                  const unsigned* __restrict__ sel, const int* __restrict__ subset,
                  const float* __restrict__ radius, float4* __restrict__ out,
                  float* __restrict__ radii, Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const int a = subset ? __ldg(subset + i) : i;
  float r, g, b, alpha;
  if (table) {
    const float4 c = __ldg(table + a);
    r = c.x, g = c.y, b = c.z, alpha = c.w;
  } else {
    const int k = __ldg(bbres + a);
    if (k < 0) {
      r = p.ss[0], g = p.ss[1], b = p.ss[2], alpha = p.ss[3];
    } else {
      const float w0 = __ldg(ss + 3 * k), w1 = __ldg(ss + 3 * k + 1), w2 = __ldg(ss + 3 * k + 2);
      r = (w0 * p.ss[0] + w1 * p.ss[4]) + w2 * p.ss[8];
      g = (w0 * p.ss[1] + w1 * p.ss[5]) + w2 * p.ss[9];
      b = (w0 * p.ss[2] + w1 * p.ss[6]) + w2 * p.ss[10];
      alpha = (w0 * p.ss[3] + w1 * p.ss[7]) + w2 * p.ss[11];
    }
  }
  if (p.tint) {
    r = (float)((double)(r * p.tint_keep) + p.tint_add[0]);
    g = (float)((double)(g * p.tint_keep) + p.tint_add[1]);
    b = (float)((double)(b * p.tint_keep) + p.tint_add[2]);
  }
  if (p.sat) desaturate(r, g, b, p.sat_keep, p.sat_amount, p.lum);
  if (mask && !bit(mask, a)) alpha = 0.0f;
  if (sel && !bit(sel, a)) desaturate(r, g, b, p.sel_keep, p.sel_amount, p.lum);
  out[i] = make_float4(r, g, b, alpha);
  if (radii) radii[i] = alpha > 0.0f ? __ldg(radius + a) : 0.0f;
}

}  // namespace

extern "C" int colors_launch(const float* table, const float* ss, const int* bbres,
                             const unsigned* mask, const unsigned* sel, const int* subset,
                             const float* radius, float* out, float* radii, int n,
                             const float* ss_colors, const float* lum, int tint, float tint_keep,
                             const double* tint_add, int sat, float sat_keep, float sat_amount,
                             float sel_keep, float sel_amount, void* stream) {
  Params p;
  p.n = n;
  for (int j = 0; j < 12; ++j) p.ss[j] = ss_colors[j];
  for (int j = 0; j < 3; ++j) p.lum[j] = lum[j];
  p.tint = tint;
  p.tint_keep = tint_keep;
  for (int j = 0; j < 3; ++j) p.tint_add[j] = tint_add[j];
  p.sat = sat;
  p.sat_keep = sat_keep;
  p.sat_amount = sat_amount;
  p.sel_keep = sel_keep;
  p.sel_amount = sel_amount;
  const int blocks = (n + kThreads - 1) / kThreads;
  colors_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), ss, bbres, mask, sel, subset, radius,
      reinterpret_cast<float4*>(out), radii, p);
  return (int)cudaGetLastError();
}
