// XTC (Gromacs compressed trajectory) codec — host runtime component of
// viamd_tpu_torch, a copy of viamd_tpu/native/xtc.cpp (capability mirror
// of mdlib's md_xtc.h) with two changes that leave every decoded and
// encoded byte as it was:
//   - xtc_scan also returns each frame's box (9 floats) and the byte just
//     past each frame, so a trajectory knows every frame's cell at open;
//   - xtc_read_frames reads only the byte range of the frames it decodes
//     (the reference copy reads the whole file on every call).
//
// Implements the classic xdr3dfcoord integer-quantization + variable-bit
// delta codec (Lemke / van der Spoel algorithm, as published in the
// BSD-licensed xdrfile library), re-written here: MSB-first bit stream,
// multi-base packed integer triples, small-delta runs with the water-pair
// interchange, and adaptive small-index tracking.
//
// C ABI (ctypes):
//   xtc_scan(path, max_frames, offsets*, ends*, natoms*, times*, boxes*)
//       -> nframes
//   xtc_read_frames(path, offsets*, ends*, count, natoms, coords*, boxes*)
//       -> 0/err
//   xtc_write_frames(path, coords*, boxes*, nframes, natoms, precision) -> 0
//
// Coordinates cross the ABI in nanometers (the on-disk unit); the Python
// layer converts to Å.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <sys/types.h>

namespace {

constexpr int MAGIC = 1995;
constexpr int FIRSTIDX = 9;

static const int magicints[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216};
constexpr int LASTIDX = int(sizeof(magicints) / sizeof(int));

// ---------------------------------------------------------------------------
// big-endian primitive IO
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | uint32_t(p[3]);
    p += 4;
    return v;
  }
  int32_t i32() { return int32_t(u32()); }
  float f32() {
    uint32_t v = u32();
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
  void skip(size_t n) {
    // compare against the remaining size, not p + n (pointer overflow UB
    // on huge corrupt counts)
    if (n > size_t(end - p)) ok = false; else p += n;
  }
};

struct Writer {
  std::vector<uint8_t> out;
  void u32(uint32_t v) {
    out.push_back(v >> 24); out.push_back(v >> 16);
    out.push_back(v >> 8); out.push_back(v);
  }
  void i32(int32_t v) { u32(uint32_t(v)); }
  void f32(float f) {
    uint32_t v;
    std::memcpy(&v, &f, 4);
    u32(v);
  }
};

// ---------------------------------------------------------------------------
// bit stream (MSB-first, matching xdrfile's sendbits/receivebits)
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> bytes;
  int lastbits = 0;
  uint32_t lastbyte = 0;
  void bits(int nbits, uint32_t num) {
    uint32_t mask = nbits < 32 ? (1u << nbits) - 1 : 0xffffffffu;
    num &= mask;
    while (nbits >= 8) {
      lastbyte = (lastbyte << 8) | ((num >> (nbits - 8)) & 0xff);
      bytes.push_back(uint8_t(lastbyte >> lastbits));
      nbits -= 8;
    }
    if (nbits > 0) {
      lastbyte = (lastbyte << nbits) | (num & ((1u << nbits) - 1));
      lastbits += nbits;
      if (lastbits >= 8) {
        lastbits -= 8;
        bytes.push_back(uint8_t(lastbyte >> lastbits));
      }
    }
  }
  void flush() {
    if (lastbits > 0) {
      bytes.push_back(uint8_t(lastbyte << (8 - lastbits)));
      lastbits = 0;
    }
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t cnt = 0;
  int lastbits = 0;
  uint32_t lastbyte = 0;
  uint32_t bits(int nbits) {
    int num = 0;
    uint32_t mask = nbits < 32 ? (1u << nbits) - 1 : 0xffffffffu;
    while (nbits >= 8) {
      lastbyte = (lastbyte << 8) | next();
      num |= (lastbyte >> lastbits) << (nbits - 8);
      nbits -= 8;
    }
    if (nbits > 0) {
      if (lastbits < nbits) {
        lastbits += 8;
        lastbyte = (lastbyte << 8) | next();
      }
      lastbits -= nbits;
      num |= (lastbyte >> lastbits) & ((1 << nbits) - 1);
    }
    return uint32_t(num) & mask;
  }
  uint8_t next() { return cnt < size ? data[cnt++] : 0; }
};

static int sizeofint(int size) {
  int num = 1, nbits = 0;
  while (size >= num && nbits < 32) {
    nbits++;
    num <<= 1;
  }
  return nbits;
}

static int sizeofints(int nints, const unsigned int sizes[]) {
  int i, num;
  unsigned int nbytes = 1, bytes[32];
  unsigned int bytecnt, tmp;
  bytes[0] = 1;
  int nbits = 0;
  for (i = 0; i < nints; i++) {
    tmp = 0;
    for (bytecnt = 0; bytecnt < nbytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    nbytes = bytecnt;
  }
  num = 1;
  nbytes--;
  while (int(bytes[nbytes]) >= num) {
    nbits++;
    num *= 2;
  }
  return nbits + int(nbytes) * 8;
}

static void sendints(BitWriter& bw, int nints, int nbits,
                     const unsigned int sizes[], const int nums[]) {
  int i;
  unsigned int bytes[32], bytecnt = 0, tmp;
  unsigned int num_of_bytes = 0;
  // multi-precision: acc = ((nums[0]*s1 + nums[1])*s2 + nums[2]) ...
  bytes[0] = 0;
  tmp = unsigned(nums[0]);
  num_of_bytes = 0;
  do {
    bytes[num_of_bytes++] = tmp & 0xff;
    tmp >>= 8;
  } while (tmp != 0);
  for (i = 1; i < nints; i++) {
    // multiply current bytes by sizes[i] and add nums[i]
    tmp = unsigned(nums[i]);
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  if (nbits >= int(num_of_bytes) * 8) {
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++)
      bw.bits(8, bytes[bytecnt]);
    bw.bits(nbits - int(num_of_bytes) * 8, 0);
  } else {
    for (bytecnt = 0; bytecnt + 1 < num_of_bytes; bytecnt++)
      bw.bits(8, bytes[bytecnt]);
    bw.bits(nbits - (int(num_of_bytes) - 1) * 8, bytes[bytecnt]);
  }
}

static void receiveints(BitReader& br, int nints, int nbits,
                        const unsigned int sizes[], int nums[]) {
  int bytes[32];
  int i, j, num_of_bytes = 0, p, num;
  bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
  while (nbits > 8) {
    bytes[num_of_bytes++] = int(br.bits(8));
    nbits -= 8;
  }
  if (nbits > 0) bytes[num_of_bytes++] = int(br.bits(nbits));
  for (i = nints - 1; i > 0; i--) {
    num = 0;
    for (j = num_of_bytes - 1; j >= 0; j--) {
      num = (num << 8) | bytes[j];
      p = num / int(sizes[i]);
      bytes[j] = p;
      num = num - p * int(sizes[i]);
    }
    nums[i] = num;
  }
  nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

// NOTE on sendints ordering vs receiveints: receiveints consumes bytes
// MSB-first into bytes[0..] then interprets bytes[0] as LOW byte — meaning
// the writer must emit the HIGH bytes first. The xdrfile encoder achieves
// this by writing `num_of_bits` total with high zero-padding first; we
// mirror the exact structure above (leading full bytes, then remainder),
// validated by the round-trip tests in tests/test_io_formats.py.

// ---------------------------------------------------------------------------
// 3dfcoord decode/encode
// ---------------------------------------------------------------------------

static bool decode_coords(Reader& r, int lsize, float* out /* lsize*3 */) {
  if (lsize <= 9) {
    for (int i = 0; i < lsize * 3; i++) out[i] = r.f32();
    return r.ok;
  }
  float precision = r.f32();
  if (precision <= 0) precision = 1000.0f;
  float inv_precision = 1.0f / precision;
  int minint[3], maxint[3];
  for (int k = 0; k < 3; k++) minint[k] = r.i32();
  for (int k = 0; k < 3; k++) maxint[k] = r.i32();
  int smallidx = r.i32();
  // smallidx below FIRSTIDX indexes the zero entries of magicints —
  // sizesmall would be 0 and receiveints divides by sizes[i] (SIGFPE on
  // corrupt files); real encoders never emit < FIRSTIDX
  if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return false;
  int tmp = smallidx + 8;
  tmp = smallidx - 1;
  tmp = (FIRSTIDX > tmp) ? FIRSTIDX : tmp;
  int smaller = magicints[tmp] / 2;
  int smallnum = magicints[smallidx] / 2;
  unsigned int sizesmall[3] = {
      (unsigned)magicints[smallidx], (unsigned)magicints[smallidx],
      (unsigned)magicints[smallidx]};

  unsigned int sizeint[3];
  int bitsizeint[3] = {0, 0, 0};
  int bitsize;
  bool large = false;
  for (int k = 0; k < 3; k++) {
    sizeint[k] = unsigned(maxint[k] - minint[k]) + 1;
    if (sizeint[k] == 0) return false;  // corrupt extents: receiveints
    if (sizeint[k] > 0xffffff) large = true;  // would divide by zero
  }
  if (large) {
    for (int k = 0; k < 3; k++) bitsizeint[k] = sizeofint(int(sizeint[k]));
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  int nbytes = r.i32();
  // padded size computed in size_t: (nbytes + 3) overflows int for
  // corrupt nbytes near INT_MAX, corrupting the bounds check
  size_t padded = (size_t(nbytes) + 3) & ~size_t(3);
  if (!r.ok || nbytes < 0 || padded > size_t(r.end - r.p)) return false;
  BitReader br{r.p, size_t(nbytes)};
  r.skip(padded);

  int thiscoord[3], prevcoord[3] = {0, 0, 0};
  int run = 0;
  int i = 0;
  float* lfp = out;
  while (i < lsize) {
    if (bitsize == 0) {
      for (int k = 0; k < 3; k++) thiscoord[k] = int(br.bits(bitsizeint[k]));
    } else {
      receiveints(br, 3, bitsize, sizeint, thiscoord);
    }
    i++;
    for (int k = 0; k < 3; k++) {
      thiscoord[k] += minint[k];
      prevcoord[k] = thiscoord[k];
    }
    int flag = int(br.bits(1));
    int is_smaller = 0;
    if (flag == 1) {
      run = int(br.bits(5));
      is_smaller = run % 3;
      run -= is_smaller;
      is_smaller--;
    } else {
      run = 0;
    }
    if (run > 0) {
      // corrupt input guard: a 5-bit run field can claim more atoms than
      // remain in the frame — without this check the run loop writes past
      // `out` (heap corruption; found by the r2 corrupt-file fuzz)
      if (i + run / 3 > lsize) return false;
      for (int k = 0; k < run; k += 3) {
        receiveints(br, 3, smallidx, sizesmall, thiscoord);
        i++;
        for (int d = 0; d < 3; d++) thiscoord[d] += prevcoord[d] - smallnum;
        if (k == 0) {
          // water-pair interchange: swap, emit the delta atom first
          for (int d = 0; d < 3; d++) {
            int t = thiscoord[d];
            thiscoord[d] = prevcoord[d];
            prevcoord[d] = t;
          }
          for (int d = 0; d < 3; d++) *lfp++ = prevcoord[d] * inv_precision;
        } else {
          for (int d = 0; d < 3; d++) prevcoord[d] = thiscoord[d];
        }
        for (int d = 0; d < 3; d++) *lfp++ = thiscoord[d] * inv_precision;
      }
    } else {
      for (int d = 0; d < 3; d++) *lfp++ = thiscoord[d] * inv_precision;
    }
    smallidx += is_smaller;
    // corrupt-input clamp: is_smaller=+1 at smallidx==LASTIDX-1 would
    // index magicints[LASTIDX] (OOB read); <FIRSTIDX hits the zero rows
    // (division by zero in receiveints)
    if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return false;
    if (is_smaller < 0) {
      smallnum = smaller;
      if (smallidx > FIRSTIDX)
        smaller = magicints[smallidx - 1] / 2;
      else
        smaller = 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = magicints[smallidx] / 2;
    }
    sizesmall[0] = sizesmall[1] = sizesmall[2] = unsigned(magicints[smallidx]);
    if (sizesmall[0] == 0) return false;
  }
  return i == lsize;
}

static void encode_coords(Writer& w, int lsize, const float* in,
                          float precision) {
  if (lsize <= 9) {
    for (int i = 0; i < lsize * 3; i++) w.f32(in[i]);
    return;
  }
  w.f32(precision);
  std::vector<int> ip(size_t(lsize) * 3);
  int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  for (int i = 0; i < lsize; i++) {
    for (int d = 0; d < 3; d++) {
      float v = in[i * 3 + d] * precision;
      int lint = int(v < 0 ? v - 0.5f : v + 0.5f);
      ip[size_t(i) * 3 + d] = lint;
      if (lint < minint[d]) minint[d] = lint;
      if (lint > maxint[d]) maxint[d] = lint;
    }
  }
  for (int d = 0; d < 3; d++) w.i32(minint[d]);
  for (int d = 0; d < 3; d++) w.i32(maxint[d]);

  unsigned int sizeint[3];
  int bitsizeint[3] = {0, 0, 0};
  int bitsize;
  bool large = false;
  for (int d = 0; d < 3; d++) {
    sizeint[d] = unsigned(maxint[d] - minint[d]) + 1;
    if (sizeint[d] > 0xffffff) large = true;
  }
  if (large) {
    for (int d = 0; d < 3; d++) bitsizeint[d] = sizeofint(int(sizeint[d]));
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }
  // small-delta runs (fixed smallidx, is_smaller always 0): consecutive
  // atoms whose deltas fit in magicints[smallidx] encode as runs of
  // smallidx-bit triplets instead of full bitsize ints — gromacs-
  // comparable sizes for liquid data. smallidx is chosen from the p90 of
  // adjacent-atom deltas so most neighbors fit while each delta stays
  // narrow. Run structure mirrors decode_coords exactly: the ANCHOR int
  // is output-atom i+1, delta 0 recovers atom i (the water-pair swap),
  // delta 1 chains from atom i, deltas 2.. chain consecutively.
  int smallidx = FIRSTIDX;
  {
    std::vector<int> dmax;
    dmax.reserve(size_t(lsize));
    for (int i = 0; i + 1 < lsize; i++) {
      int m = 0;
      for (int d = 0; d < 3; d++) {
        int diff = ip[size_t(i + 1) * 3 + d] - ip[size_t(i) * 3 + d];
        if (diff < 0) diff = -diff;
        if (diff > m) m = diff;
      }
      dmax.push_back(m);
    }
    int target = 1023;
    if (!dmax.empty()) {
      size_t k = dmax.size() * 9 / 10;
      std::nth_element(dmax.begin(), dmax.begin() + k, dmax.end());
      target = dmax[k] * 2 + 1;  // smallnum = sizesmall/2 must cover it
    }
    while (smallidx < LASTIDX - 2 && magicints[smallidx] < target)
      smallidx++;
  }
  w.i32(smallidx);
  const int sizesmall_s = magicints[smallidx];
  const int smallnum = sizesmall_s / 2;
  unsigned int sizesmall[3] = {unsigned(sizesmall_s), unsigned(sizesmall_s),
                               unsigned(sizesmall_s)};
  // magicints invariant: 3 ints of magicints[idx] pack into exactly idx
  // bits — the decoder reads run deltas with num_of_bits = smallidx
  const int run_bits = smallidx;
  auto fits = [&](const int* a, const int* b) {
    // delta b−a encodes as b−a+smallnum ∈ [0, sizesmall)
    for (int d = 0; d < 3; d++) {
      int v = b[d] - a[d] + smallnum;
      if (v < 0 || v >= sizesmall_s) return false;
    }
    return true;
  };

  BitWriter bw;
  int thiscoord[3];
  int i = 0;
  while (i < lsize) {
    // try a run anchored at atom i+1 recovering atoms i, i+1, i+2, ...
    int n_deltas = 0;
    if (i + 1 < lsize && run_bits < bitsize + (bitsize == 0 ? 1 << 30 : 0) &&
        fits(&ip[size_t(i + 1) * 3], &ip[size_t(i) * 3])) {
      n_deltas = 1;  // delta 0: atom i from anchor i+1
      const int* prev = &ip[size_t(i) * 3];  // chain continues from atom i
      for (int j = i + 2; j < lsize && n_deltas < 8; j++) {
        if (!fits(prev, &ip[size_t(j) * 3])) break;
        n_deltas++;
        prev = &ip[size_t(j) * 3];
      }
    }
    int anchor = (n_deltas > 0) ? i + 1 : i;
    for (int d = 0; d < 3; d++)
      thiscoord[d] = ip[size_t(anchor) * 3 + d] - minint[d];
    if (bitsize == 0) {
      for (int d = 0; d < 3; d++)
        bw.bits(bitsizeint[d], unsigned(thiscoord[d]));
    } else {
      sendints(bw, 3, bitsize, sizeint, thiscoord);
    }
    if (n_deltas == 0) {
      bw.bits(1, 0);  // no run
      i++;
      continue;
    }
    bw.bits(1, 1);
    bw.bits(5, unsigned(3 * n_deltas + 1));  // run ints + (is_smaller+1)
    const int* prev = &ip[size_t(anchor) * 3];
    int src = i;  // delta 0 encodes atom i relative to the anchor
    for (int k = 0; k < n_deltas; k++) {
      int delta[3];
      const int* cur = &ip[size_t(src) * 3];
      for (int d = 0; d < 3; d++) delta[d] = cur[d] - prev[d] + smallnum;
      sendints(bw, 3, run_bits, sizesmall, delta);
      prev = cur;
      // after delta 0 (atom i), the chain walks atoms i+2, i+3, ...
      src = (k == 0) ? i + 2 : src + 1;
    }
    i += n_deltas + 1;
  }
  bw.flush();
  w.i32(int(bw.bytes.size()));
  w.out.insert(w.out.end(), bw.bytes.begin(), bw.bytes.end());
  while (w.out.size() % 4) w.out.push_back(0);
}

// ---------------------------------------------------------------------------
// file-level API
// ---------------------------------------------------------------------------

struct FileBuf {
  std::vector<uint8_t> data;
  bool ok = false;
};

static FileBuf slurp(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  fb.data.resize(size_t(n));
  fb.ok = std::fread(fb.data.data(), 1, size_t(n), f) == size_t(n);
  std::fclose(f);
  return fb;
}

}  // namespace

extern "C" {

// Scan frame offsets. Returns number of frames (≤ max_frames), or -1.
// offsets[i] / ends[i]: the first byte of frame i and the byte just past
// it; boxes: 9 floats (nm) per frame.
int64_t xtc_scan(const char* path, int64_t max_frames, int64_t* offsets,
                 int64_t* ends, int32_t* natoms_out, double* times,
                 float* boxes) {
  FileBuf fb = slurp(path);
  if (!fb.ok) return -1;
  const uint8_t* base = fb.data.data();
  Reader r{base, base + fb.data.size()};
  int64_t nframes = 0;
  int natoms_first = -1;
  float box[9];
  while (r.p + 4 <= r.end && nframes < max_frames) {
    const uint8_t* frame_start = r.p;
    int magic = r.i32();
    if (!r.ok) break;
    if (magic != MAGIC) return -1;
    int natoms = r.i32();
    r.i32();  // step
    float time = r.f32();
    if (natoms_first < 0) natoms_first = natoms;
    if (natoms != natoms_first) return -1;
    for (int k = 0; k < 9; k++) box[k] = r.f32();
    int lsize = r.i32();
    if (lsize != natoms) return -1;
    if (lsize <= 9) {
      r.skip(size_t(lsize) * 3 * 4);
    } else {
      r.f32();                      // precision
      for (int k = 0; k < 7; k++) r.i32();  // minint, maxint, smallidx
      int nbytes = r.i32();
      if (nbytes < 0) return -1;
      r.skip((size_t(nbytes) + 3) & ~size_t(3));
    }
    if (!r.ok) break;
    offsets[nframes] = frame_start - base;
    ends[nframes] = r.p - base;
    times[nframes] = double(time);
    for (int k = 0; k < 9; k++) boxes[nframes * 9 + k] = box[k];
    nframes++;
  }
  *natoms_out = natoms_first;
  return nframes;
}

// Read frames at byte offsets into coords (count*natoms*3 f32, nm) and
// boxes (count*9 f32, nm). Only the bytes from the smallest offset to the
// largest end are read. Returns 0 on success.
int32_t xtc_read_frames(const char* path, const int64_t* offsets,
                        const int64_t* ends, int64_t count, int32_t natoms,
                        float* coords, float* boxes) {
  if (count <= 0) return 0;
  int64_t lo = offsets[0], hi = ends[0];
  for (int64_t i = 1; i < count; i++) {
    lo = std::min(lo, offsets[i]);
    hi = std::max(hi, ends[i]);
  }
  if (lo < 0 || hi < lo) return 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<uint8_t> data(size_t(hi - lo));
  bool ok = fseeko(f, off_t(lo), SEEK_SET) == 0 &&
            std::fread(data.data(), 1, data.size(), f) == data.size();
  std::fclose(f);
  if (!ok) return 1;
  const uint8_t* base = data.data();
  const uint8_t* end = base + data.size();
  for (int64_t i = 0; i < count; i++) {
    Reader r{base + (offsets[i] - lo), end};
    if (r.i32() != MAGIC) return 2;
    int na = r.i32();
    if (na != natoms) return 3;
    r.i32();
    r.f32();
    for (int k = 0; k < 9; k++) boxes[i * 9 + k] = r.f32();
    int lsize = r.i32();
    if (lsize != natoms) return 4;
    if (!decode_coords(r, lsize, coords + i * int64_t(natoms) * 3)) return 5;
  }
  return 0;
}

// Write frames (coords nm, boxes nm). Returns 0 on success.
int32_t xtc_write_frames(const char* path, const float* coords,
                         const float* boxes, int64_t nframes, int32_t natoms,
                         float precision) {
  Writer w;
  for (int64_t i = 0; i < nframes; i++) {
    w.i32(MAGIC);
    w.i32(natoms);
    w.i32(int32_t(i));
    w.f32(float(i));
    for (int k = 0; k < 9; k++) w.f32(boxes[i * 9 + k]);
    w.i32(natoms);
    encode_coords(w, natoms, coords + i * int64_t(natoms) * 3, precision);
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  size_t wr = std::fwrite(w.out.data(), 1, w.out.size(), f);
  std::fclose(f);
  return wr == w.out.size() ? 0 : 2;
}

}  // extern "C"
