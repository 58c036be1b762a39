"""RecordIO: sequential and indexed record files, and image records
(counterpart of ``mxnet_tpu/recordio.py``; reference
``python/mxnet/recordio.py``: MXRecordIO :37, MXIndexedRecordIO :216,
IRHeader pack/unpack :344-371, and the dmlc-core framing it wraps).  The
on-disk format is the JAX package's byte for byte, so a file written by
either package reads in the other:

* each record is ``[magic:u32][flag_len:u32][payload][pad to 4B]`` where the top
  3 bits of ``flag_len`` are a continuation flag and the low 29 bits the length;
* ``.idx`` sidecar is the text ``key\\tbyte_offset`` per line;
* image records prepend an ``IRHeader`` (flag, label, id, id2) with optional
  variable-length float label vector when ``flag`` carries its count.

``pack_img``/``unpack_img`` import PIL when called; augmentation and
batching live in ``io.ImageRecordIter``.  ``MXIndexedRecordIO.read_batch``
reads many records in one call of the native reader
(``io/native.py``) where it built, else record by record.
"""
from __future__ import annotations

import collections
import io as _io
import os
import struct
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LEN_BITS = 29
_LEN_MASK = (1 << _LEN_BITS) - 1
_U32 = struct.Struct("<I")


def _native_module():
    """The native reader (``io/native.py``) when it built, else ``None``;
    imported at call time (``io`` imports this module)."""
    try:
        from .io import native as _native
        return _native if _native.available() else None
    except Exception:
        return None


def _encode_flag_len(cflag: int, length: int) -> int:
    return (cflag << _LEN_BITS) | length


class MXRecordIO:
    """Sequential record reader/writer (reference recordio.py:37)."""

    def __init__(self, uri: str, flag: str):
        if flag not in ("r", "w"):
            raise ValueError(f"flag must be 'r' or 'w', got {flag!r}")
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        self.record = open(self.uri, "rb" if self.flag == "r" else "wb")
        self.writable = self.flag == "w"

    def close(self):
        if self.record is not None and not self.record.closed:
            self.record.close()

    def reset(self):
        """Reopen at the start (read mode)."""
        self.close()
        self.open()

    def __del__(self):
        self.close()

    # pickling support for multiprocess data workers (reference __getstate__)
    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        if self.flag == "w":
            raise RuntimeError("cannot pickle a writable MXRecordIO")
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def tell(self) -> int:
        return self.record.tell()

    def write(self, buf: bytes):
        assert self.writable, "not opened for writing"
        n = len(buf)
        if n > _LEN_MASK:
            raise ValueError(f"record too large: {n} > {_LEN_MASK} bytes")
        self.record.write(_U32.pack(_MAGIC))
        self.record.write(_U32.pack(_encode_flag_len(0, n)))
        self.record.write(buf)
        pad = (-n) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        assert not self.writable, "not opened for reading"
        head = self.record.read(8)
        if len(head) < 8:
            return None
        magic, = _U32.unpack_from(head, 0)
        if magic != _MAGIC:
            raise IOError(f"invalid record magic {magic:#x} in {self.uri}")
        flag_len, = _U32.unpack_from(head, 4)
        cflag, n = flag_len >> _LEN_BITS, flag_len & _LEN_MASK
        if cflag != 0:
            raise IOError("multi-part records are not supported by this reader")
        buf = self.record.read(n)
        if len(buf) < n:
            raise IOError(f"truncated record in {self.uri}")
        pad = (-n) % 4
        if pad:
            self.record.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file via a ``key\\toffset`` index (reference :216)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx: Dict = {}
        self.keys: List = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def seek(self, idx):
        assert not self.writable
        self.record.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)

    # -- native batched reads (csrc/recordio_core.cc) ----------------------
    def _native_pairs(self):
        """record offset -> (payload offset, size), from one native scan."""
        cached = getattr(self, "_native_scan", None)
        if cached is not None:
            return cached
        nat = _native_module()
        if nat is None:
            self._native_scan = {}
            return self._native_scan
        try:
            offs, sizes = nat.index_file(self.uri)
        except IOError:
            # the scan refuses the file (trailing garbage from a killed
            # writer, multi-part records): the records the .idx lists may
            # still be fine, so read them one by one in Python
            self._native_scan = {}
            return self._native_scan
        self._native_scan = {int(o) - 8: (int(o), int(s))
                             for o, s in zip(offs, sizes)}
        return self._native_scan

    def read_batch(self, keys) -> List[bytes]:
        """Many records in one native call (outside the GIL); the same
        bytes as a ``read_idx`` loop, which reads them where the native
        library is missing."""
        nat = _native_module()
        if nat is not None:
            pairs = self._native_pairs()
            try:
                sel = [pairs[self.idx[k]] for k in keys]
            except KeyError:
                sel = None  # a stale or partial scan: read one by one
            if sel is not None:
                try:
                    return nat.read_batch(self.uri, [p[0] for p in sel],
                                          [p[1] for p in sel])
                except IOError:
                    pass  # read one by one
        return [self.read_idx(k) for k in keys]


# ---------------------------------------------------------------------------
# image records
# ---------------------------------------------------------------------------
IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = struct.Struct("<IfQQ")


def pack(header: IRHeader, s: bytes) -> bytes:
    """Serialize header + payload.  A vector label is appended as float32s with
    its length recorded in ``flag`` (reference recordio.py:344)."""
    label = header.label
    if np.ndim(label) != 0:
        vec = np.asarray(label, dtype=np.float32)
        header = header._replace(flag=vec.size, label=0.0)
        s = vec.tobytes() + s
    return _IR_FORMAT.pack(header.flag, float(header.label),
                           header.id, header.id2) + s


def unpack(s: bytes):
    """Inverse of :func:`pack`; returns (IRHeader, payload bytes)."""
    flag, label, id_, id2 = _IR_FORMAT.unpack_from(s, 0)
    body = s[_IR_FORMAT.size:]
    header = IRHeader(flag, label, id_, id2)
    if flag > 0 and len(body) >= 4 * flag:
        # heuristic matches the writer: flag>0 means a packed label vector
        vec = np.frombuffer(body[:4 * flag], dtype=np.float32)
        header = header._replace(label=vec)
        body = body[4 * flag:]
    return header, body


def pack_img(header: IRHeader, img: np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image and pack it (reference recordio.py pack_img)."""
    from PIL import Image

    buf = _io.BytesIO()
    pil = Image.fromarray(np.asarray(img, dtype=np.uint8))
    fmt = img_fmt.lower().lstrip(".")
    if fmt in ("jpg", "jpeg"):
        pil.save(buf, format="JPEG", quality=quality)
    elif fmt == "png":
        pil.save(buf, format="PNG")
    else:
        raise ValueError(f"unsupported image format {img_fmt!r}")
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = 1):
    """Unpack and decode to an HWC uint8 numpy array; returns (header, img)."""
    from PIL import Image

    header, body = unpack(s)
    pil = Image.open(_io.BytesIO(body))
    pil = pil.convert("RGB" if iscolor else "L")
    return header, np.asarray(pil)

