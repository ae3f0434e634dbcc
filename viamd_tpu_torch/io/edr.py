"""GROMACS .edr energy-file reader (+ writer for tests) — copy of
viamd_tpu.io.edr.

Rebuilds the reference's script-import support for energy files:
viamd lists "edr" in SCRIPT_IMPORT_FILE_EXTENSIONS
(VIAMD src/viamd.h:86) and injects `table = import("x.edr")`
into the script on file drop (VIAMD src/viamd.cpp:2833-2858);
the parser itself lives in mdlib (md_edr), an empty submodule in the
snapshot — this implementation follows the public GROMACS enxio/XDR
wire format (src/gromacs/fileio/enxio.cpp; same layout the pure-python
`panedr`/`pyedr` readers implement):

  do_enxnms:  int32 magic (>0 → file v1, magic==nre; else -55555,
              then int32 file_version, int32 nre), then nre XDR strings
              (v≥2 prefixed by an extra length int).
  do_eheader: real first_value; > -1e10 → v1 frame (value is t, then
              int32 step); else it is the ~-2e10 sentinel (doubles as
              the precision check), then int32 magic -7777777, int32
              version, float64 t, int64 step, int32 nsum, (v≥3) int64
              nsteps, (v≥5) float64 dt. COMMON to both formats: int32
              nre, (v<4) int32 ndisre, int32 nblock, int32 e_size,
              (v<4) int32 disre_e_size / (v≥4) 2 reserved int32, block
              descriptors (v≥4: id+nsub+sub types/lengths; v1: bare
              real counts), then per-term real e [, eav, esum]
              (stored when v==1 or nsum>0; v1 adds a dummy 4th real).

Precision is not recorded in the file; like GROMACS we detect it by
validating the header under float32 then float64 reals.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_MAGIC_NMS = -55555
_MAGIC_FRAME = -7777777  # int32, follows the sentinel real
_SENTINEL = -2e10  # first real of a new-format frame (precision check)
_VERSION = 5


class _XDR:
    """Minimal big-endian XDR unpacker (xdrlib was removed in py3.13)."""

    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def _take(self, n: int) -> bytes:
        if self.p + n > len(self.d):
            raise EOFError("truncated edr data")
        b = self.d[self.p : self.p + n]
        self.p += n
        return b

    def int(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def hyper(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def float32(self) -> float:
        return struct.unpack(">f", self._take(4))[0]

    def float64(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def real(self, double: bool) -> float:
        return self.float64() if double else self.float32()

    def string(self) -> str:
        n = self.int()
        pad = (4 - n % 4) % 4
        raw = self._take(n + pad)[:n]
        return raw.rstrip(b"\x00").decode("utf-8", errors="replace")

    @property
    def remaining(self) -> int:
        return len(self.d) - self.p


# XDR wire sizes per sub-block datatype (xdr_datatype enum):
# int=4, float=4, double=8, int64=8, char (XDR-padded)=4, string≈4+
_SUB_SIZE = {0: 4, 1: 4, 2: 8, 3: 8, 4: 4, 5: 4}


def _read_names(x: _XDR) -> tuple[int, int, list[str]]:
    magic = x.int()
    if magic > 0:
        return 1, magic, [x.string() for _ in range(magic)]
    if magic != _MAGIC_NMS:
        raise ValueError(f"not an edr file (magic {magic})")
    file_version = x.int()
    nre = x.int()
    names = []
    for _ in range(nre):
        if file_version >= 2:
            x.int()  # extra length word written by newer gromacs
        names.append(x.string())
    return file_version, nre, names


def _read_frame(
    x: _XDR, nre_nms: int, double: bool
) -> Optional[tuple[float, np.ndarray]]:
    first = x.real(double)
    if first > -1e10:
        # file-version-1 frame: first value is t, then int step; the
        # nre/block section below is COMMON to old and new formats
        # (GROMACS do_eheader reads it for both)
        version = 1
        t = float(first)
        x.int()  # step
        nsum = 0
    else:
        # new format: sentinel real ~-2e10 (precision check), int magic
        magic = x.int()
        if magic != _MAGIC_FRAME:
            raise ValueError(f"bad frame magic {magic} (sentinel {first})")
        version = x.int()
        t = x.float64()
        x.hyper()  # step
        nsum = x.int()
        if version >= 3:
            x.hyper()  # nsteps
        if version >= 5:
            x.float64()  # dt
    nre = x.int()
    ndisre = x.int() if version < 4 else 0
    nblock = x.int()
    x.int()  # e_size
    if version < 4:
        x.int()  # disre e_size
        if (nblock or ndisre) and version > 1:
            # v2-v3 block payloads use a bare per-block size layout we
            # have no ground truth for — fail loudly over silent garbage
            raise ValueError(
                f"edr file_version {version} with blocks unsupported"
            )
    else:
        x.int()  # reserved
        x.int()  # reserved
    block_bytes = 0
    if version >= 4:
        for _ in range(nblock):
            x.int()  # block id
            nsub = x.int()
            for _ in range(nsub):
                sub_type = x.int()
                sub_n = x.int()
                sz = _SUB_SIZE.get(sub_type, 4)
                n = sub_n * sz
                block_bytes += n + (4 - n % 4) % 4
    elif nblock:
        # v1 blocks: per-block value counts of reals
        block_bytes = sum(
            x.int() * (8 if double else 4) for _ in range(nblock)
        )
    if ndisre:
        block_bytes += ndisre * 2 * (8 if double else 4)
    if nre != nre_nms:
        raise ValueError(f"frame nre {nre} != header nre {nre_nms}")
    e = np.empty(nre)
    for i in range(nre):
        e[i] = x.real(double)
        if version == 1 or nsum > 0:
            x.real(double)  # eav
            x.real(double)  # esum
            if version == 1:
                x.real(double)
    x._take(block_bytes)
    return t, e


def _try_read(data: bytes, double: bool):
    x = _XDR(data)
    file_version, nre, names = _read_names(x)
    times, rows = [], []
    while x.remaining >= (8 if double else 4):
        t, e = _read_frame(x, nre, double)
        times.append(t)
        rows.append(e)
    return names, np.asarray(times), np.asarray(rows)


def read_edr(path: str) -> tuple[np.ndarray, list[str]]:
    """Parse a GROMACS energy file.

    Returns (cols, labels): cols is (1+nre, nframes) float32 — row 0 is
    time (ps), rows 1.. are the energy terms; labels matches
    ["Time"] + term names. Matches the script `import()` column layout
    of read_xvg/read_csv.
    """
    with open(path, "rb") as f:
        data = f.read()
    err = None
    for double in (False, True):
        try:
            names, times, rows = _try_read(data, double)
            if times.size and np.isfinite(rows).all():
                cols = np.vstack([times[None, :], rows.T]).astype(np.float32)
                return cols, ["Time"] + names
        except (EOFError, ValueError, struct.error) as e:
            err = e
    raise ValueError(f"cannot parse edr file {path!r}: {err}")


def write_edr(
    path: str,
    names: list[str],
    times: np.ndarray,
    energies: np.ndarray,
    double: bool = False,
) -> None:
    """Write a version-5 energy file (test fixture / interchange)."""
    times = np.asarray(times, np.float64)
    energies = np.asarray(energies, np.float64)
    assert energies.shape == (times.size, len(names)), energies.shape
    out = bytearray()

    def w_int(v):
        out.extend(struct.pack(">i", v))

    def w_hyper(v):
        out.extend(struct.pack(">q", v))

    def w_real(v):
        out.extend(struct.pack(">d" if double else ">f", v))

    def w_str(s):
        b = s.encode() + b"\x00"
        w_int(len(b))
        out.extend(b + b"\x00" * ((4 - len(b) % 4) % 4))

    w_int(_MAGIC_NMS)
    w_int(_VERSION)
    w_int(len(names))
    for n in names:
        w_int(len(n.encode()) + 1)  # the v>=2 extra length word
        w_str(n)
    for fi, t in enumerate(times):
        w_real(_SENTINEL)
        w_int(_MAGIC_FRAME)
        w_int(_VERSION)
        out.extend(struct.pack(">d", float(t)))
        w_hyper(fi)  # step
        w_int(0)  # nsum
        w_hyper(fi)  # nsteps
        out.extend(struct.pack(">d", 0.0))  # dt (v>=5)
        w_int(len(names))
        w_int(0)  # nblock
        w_int(len(names) * (8 if double else 4))  # e_size
        w_int(0)
        w_int(0)
        for v in energies[fi]:
            w_real(float(v))
    with open(path, "wb") as f:
        f.write(bytes(out))
