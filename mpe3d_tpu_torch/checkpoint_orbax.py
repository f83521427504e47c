"""The on-disk format of the JAX package's orbax checkpoints, read and
written with numpy, the standard library and ``ctypes`` alone.

``mpe3d_tpu/train/checkpoint.py`` saves a flat dict ``{"p.leaf_NNNNN":
array, "o.leaf_NNNNN": array}`` through orbax's ``StandardCheckpointHandler``
into ``<path>.orbax/``.  orbax writes one zarr v2 array per key through
tensorstore, in one of two layouts, and this module reads both:

* **OCDBT** (what orbax writes by default; ``_METADATA`` says
  ``"use_ocdbt": true``): the keys ``p.leaf_00000/.zarray`` (the zarr
  header, JSON) and ``p.leaf_00000/0.0`` (a chunk) live in an OCDBT
  key-value store, a B-tree of files under the directory.
  ``manifest.ocdbt`` holds the store's configuration and its versions; the
  newest version names the root node; interior nodes name their children,
  leaf nodes hold each value inline or as a (data file, offset, length)
  reference.  Every manifest and node file is framed as: a big-endian u32
  magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), a little-endian
  u64 length of the whole file, a varint version (0), a varint compression
  (0 none, 1 zstd), the body, and a little-endian crc32c of everything
  before it.  Bodies use LEB128 varints and store arrays field by field
  (all lengths, then all kinds, ...); keys are prefix-compressed, and an
  interior entry's ``subtree_common_prefix_length`` leading bytes of its
  key prefix every key below it.  Data files are named by a table at the
  top of each node (paths prefix-compressed; a base path such as
  ``ocdbt.process_0/`` included).
* **Plain zarr v2** (``"use_ocdbt": false``): one directory a key, its
  ``.zarray`` and chunk files (``0.0`` in two dimensions, ``0`` in one or
  none).  ``write_orbax_dir`` writes this layout, uncompressed
  (``"compressor": null``), one chunk of the whole array, with
  ``_CHECKPOINT_METADATA`` and ``_METADATA`` (``tree_metadata`` entries as
  orbax writes them), which JAX's ``load_checkpoint`` reads.

Chunks and OCDBT bodies compressed with zstd are decoded by
``libzstd.so.1`` through ``ctypes``; without that library, reading a
compressed checkpoint raises an error naming it (an uncompressed one reads
without it).  bfloat16 arrays (zarr dtype ``"bfloat16"``) come back as
``torch.bfloat16`` tensors with the stored bit patterns; every other
array as numpy.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import shutil
import struct
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")

# ---------------------------------------------------------------------------
# zstd and crc32c
# ---------------------------------------------------------------------------

_ZSTD = None
_ZSTD_LOCK = threading.Lock()


def zstd_library():
    """``libzstd.so.1`` through ctypes, or None where it is not installed."""
    global _ZSTD
    with _ZSTD_LOCK:
        if _ZSTD is None:
            name = ctypes.util.find_library("zstd") or "libzstd.so.1"
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                _ZSTD = False
            else:
                lib.ZSTD_decompress.restype = ctypes.c_size_t
                lib.ZSTD_decompress.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                    ctypes.c_size_t]
                lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
                lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                         ctypes.c_size_t]
                lib.ZSTD_isError.restype = ctypes.c_uint
                lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
                lib.ZSTD_getErrorName.restype = ctypes.c_char_p
                lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
                _ZSTD = lib
    return _ZSTD or None


def zstd_decompress(data: bytes, what: str,
                    size: Optional[int] = None) -> bytes:
    """Decode one zstd frame; ``size`` is the decoded size where the caller
    knows it (a chunk), else the frame's own, else a growing guess."""
    lib = zstd_library()
    if lib is None:
        raise RuntimeError(
            f"{what} is zstd-compressed, and reading it needs the zstd "
            f"library libzstd.so.1, which was not found on this machine")
    known = lib.ZSTD_getFrameContentSize(data, len(data))
    cap = size if size is not None else (
        known if known < (1 << 62) else max(1 << 16, 8 * len(data)))
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        r = lib.ZSTD_decompress(out, cap, data, len(data))
        if not lib.ZSTD_isError(r):
            if size is not None and r != size:
                raise ValueError(f"{what}: decoded {r} bytes, expected "
                                 f"{size}")
            return out.raw[:r]
        err = lib.ZSTD_getErrorName(r).decode()
        if size is not None or known < (1 << 62) or cap > (1 << 34) \
                or "too small" not in err:
            raise ValueError(f"{what}: zstd error: {err}")
        cap *= 4


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT files carry it."""
    crc, t = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b, self.p, self.what = data, 0, what

    def u8(self) -> int:
        if self.p >= len(self.b):
            raise ValueError(f"{self.what}: truncated")
        v = self.b[self.p]
        self.p += 1
        return v

    def varint(self) -> int:
        v = shift = 0
        while True:
            x = self.u8()
            v |= (x & 0x7F) << shift
            shift += 7
            if not x & 0x80:
                return v
            if shift > 63:
                raise ValueError(f"{self.what}: bad varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise ValueError(f"{self.what}: truncated")
        v = self.b[self.p:self.p + n]
        self.p += n
        return v

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]


def _framed_body(data: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node file, its frame and checksum
    checked."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes is no OCDBT file")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"{what}: length field does not match the file")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: crc32c checksum mismatch")
    r = _Reader(data[:-4], what)
    r.p = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    body = data[r.p:-4]
    if compression == 1:
        body = zstd_decompress(body, what)
    elif compression != 0:
        raise ValueError(f"{what}: compression format {compression}")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                    # base path lengths: part of each path
    paths: List[bytes] = []
    for i in range(n):
        paths.append((paths[-1][:prefix[i]] if i else b"")
                     + r.raw(suffix[i]))
    return [p.decode() for p in paths]


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys: List[bytes] = []
    for i in range(n):
        keys.append((keys[-1][:prefix[i]] if i else b"") + r.raw(suffix[i]))
    return keys, common


class OcdbtStore:
    """The newest version of an OCDBT key-value store in ``root``: its keys
    and their values (read on access)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            r = _framed_body(f.read(), MANIFEST_MAGIC,
                             os.path.join(root, "manifest.ocdbt"))
        r.raw(16)                                   # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{root}: numbered OCDBT manifests are not "
                             f"read (manifest kind {kind})")
        r.varint()                                  # max inline value bytes
        r.varint()                                  # max decoded node bytes
        r.u8()                                      # version tree arity
        if r.varint() == 1:
            r.raw(4)                                # zstd level
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            self.values: Dict[str, Any] = {}
            return
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        n_keys = r.varints(n)
        i = max(range(n), key=lambda k: gen[k])
        self.values = {}
        if n_keys[i]:
            self._node(files[fid[i]], off[i], length[i], height[i], b"")

    def _read(self, rel: str, off: int, length: int) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            f.seek(off)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{self.root}/{rel}: {len(data)} of {length} "
                             f"bytes at offset {off}")
        return data

    def _node(self, rel: str, off: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{self.root}/{rel}@{off}"
        r = _framed_body(self._read(rel, off, length), NODE_MAGIC, what)
        if r.u8() != height:
            raise ValueError(f"{what}: node height differs from its parent's"
                             f" reference")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                self._node(files[fid[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes = r.varints(n)
        kinds = [r.u8() for _ in range(n)]
        out_of_line = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: unknown value kind")
        ids = r.varints(len(out_of_line))
        offsets = r.varints(len(out_of_line))
        refs = {i: (files[f], o) for i, f, o in zip(out_of_line, ids,
                                                    offsets)}
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in refs:
                self.values[key] = refs[i] + (sizes[i],)
            else:
                self.values[key] = r.raw(sizes[i])

    def keys(self):
        return self.values.keys()

    def get(self, key: str) -> Optional[bytes]:
        v = self.values.get(key)
        if isinstance(v, tuple):
            return self._read(*v)
        return v


class _PlainStore:
    """The files of a plain zarr v2 directory as a key-value store."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        p = os.path.join(self.root, key)
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            return f.read()


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------


def _np_dtype(zdtype: str) -> np.dtype:
    if zdtype == "bfloat16":
        return np.dtype("<u2")
    return np.dtype(zdtype)


def _decode_array(store, key: str, header: Dict[str, Any], what: str):
    shape = tuple(header["shape"])
    chunks = tuple(header["chunks"])
    dt = _np_dtype(header["dtype"])
    if header.get("filters"):
        raise ValueError(f"{what}: zarr filters {header['filters']} are not "
                         f"read")
    comp = header.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: zarr compressor {comp.get('id')!r} is "
                         f"not read (zstd or none)")
    order = header.get("order", "C")
    sep = header.get("dimension_separator", ".")
    fill = header.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dt)
    grid = [-(-s // c) if c else 1 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    for idx in np.ndindex(*grid) if shape else [()]:
        ckey = f"{key}/" + (sep.join(str(i) for i in idx) if idx else "0")
        data = store.get(ckey)
        if data is None:
            continue                        # an absent chunk is fill_value
        if comp is not None:
            data = zstd_decompress(data, f"{what} chunk {ckey}",
                                   chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{what}: chunk {ckey} has {len(data)} bytes, "
                             f"expected {chunk_bytes}")
        block = np.frombuffer(data, dtype=dt)
        block = (block.reshape(chunks) if order == "C"
                 else block.reshape(chunks[::-1]).T)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if header["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16).copy()).view(
            torch.bfloat16)
    return out


class OrbaxCheckpoint(Mapping):
    """The leaves of an orbax checkpoint directory by key (``p.leaf_00000``,
    ``o.leaf_00000``, ...), either layout, each decoded when first read."""

    def __init__(self, path: str):
        self.path = path
        meta_file = os.path.join(path, "_METADATA")
        if not os.path.isfile(meta_file):
            raise FileNotFoundError(f"{path}: no _METADATA (not an orbax "
                                    f"checkpoint)")
        with open(meta_file) as f:
            self.metadata = json.load(f)
        names = []
        for k, v in self.metadata.get("tree_metadata", {}).items():
            key = [e["key"] for e in v.get("key_metadata", ())]
            if len(key) != 1:
                raise ValueError(f"{path}: tree key {k} is not a flat key")
            names.append(key[0])
        if self.metadata.get("use_zarr3"):
            raise ValueError(f"{path}: zarr3 checkpoints are not read")
        self.store = (OcdbtStore(path) if self.metadata.get("use_ocdbt")
                      else _PlainStore(path))
        self._names = sorted(names)
        self._cache: Dict[str, Any] = {}

    def __getitem__(self, name: str):
        if name not in self._cache:
            if name not in self._names:
                raise KeyError(name)
            raw = self.store.get(f"{name}/.zarray")
            if raw is None:
                raise ValueError(f"{self.path}: leaf {name} has no .zarray")
            self._cache[name] = _decode_array(
                self.store, name, json.loads(raw), f"{self.path}/{name}")
        return self._cache[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def embedded_meta(self) -> Optional[Dict[str, Any]]:
        p = os.path.join(self.path, "_mpe3d_meta.json")
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# writing the plain layout
# ---------------------------------------------------------------------------


def _host_bytes(leaf) -> Tuple[bytes, str, Tuple[int, ...]]:
    """(C-order bytes, zarr dtype, shape) of a leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), "bfloat16",
                    tuple(t.shape))
        leaf = t.numpy()
    a = np.asarray(leaf)            # tobytes() below is C order
    if a.dtype == object:
        raise TypeError(f"cannot save a leaf of type {type(leaf).__name__}")
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a.tobytes(), a.dtype.str, tuple(a.shape)


def write_orbax_dir(path: str, flat: Dict[str, Any]) -> None:
    """Write ``flat`` ({key: array or tensor}) at ``path`` (a directory that
    must not exist) in the plain zarr v2 layout, each array one
    uncompressed chunk; the directory is assembled under a temporary name
    and renamed into place, so ``path`` appears complete or not at all."""
    t0 = time.time_ns()
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp)
    try:
        tree = {}
        for name, leaf in flat.items():
            data, zdtype, shape = _host_bytes(leaf)
            d = os.path.join(tmp, name)
            os.makedirs(d)
            header = {"chunks": list(shape), "compressor": None,
                      "dimension_separator": ".", "dtype": zdtype,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(shape), "zarr_format": 2}
            with open(os.path.join(d, ".zarray"), "w") as f:
                json.dump(header, f)
            with open(os.path.join(d, ".".join("0" for _ in shape) or "0"),
                      "wb") as f:
                f.write(data)
            tree[f"('{name}',)"] = {
                "key_metadata": [{"key": name, "key_type": 2}],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {}, "init_timestamp_nsecs": t0,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
