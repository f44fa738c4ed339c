"""The orbax checkpoint tier's directories, read and written with numpy and
the standard library: no JAX, orbax or tensorstore.

The JAX package has no such module: its tier calls orbax inside
training/checkpoint.py (`ocp.StandardCheckpointer`, JAX
checkpoint.py:134-179).  The port reads and writes the same directories
itself.  What they hold (orbax-checkpoint 0.11.32 over tensorstore 0.1.80):

  _METADATA   JSON.  `tree_metadata`, keyed by the tuple-string of each
              leaf's path: `key_metadata` [{key, key_type}] (1: a sequence
              index, 2: a dict key) and `value_metadata` (value_type
              "jax.Array", write_shape); `use_ocdbt`, `use_zarr3`.
  one zarr v2 array a leaf, under the leaf's keys joined by '.':
              `<name>/.zarray` (JSON: shape, chunks, dtype, order,
              fill_value, compressor, dimension_separator) and one chunk a
              cell of the chunk grid (`<name>/0.0`, ...; `<name>/0` for a
              0-d array).  A sharded save writes several chunks.
  with use_ocdbt, those keys live in an OCDBT database (`manifest.ocdbt`
  and `d/`; each process of a save also writes `ocdbt.process_<n>/`, which
  the top-level manifest then covers); without it they are plain files.

The OCDBT layout (tensorstore's "OCDBT on-disk format"), as read here and
held to tensorstore's own reads by tests/test_torch_orbax_tier.py:
  every manifest, version tree node and B-tree node: a u32 big-endian magic
  (0x0cdb3a2a manifest, 0x0cdb1234 version tree node, 0x0cdb20de B-tree
  node), a u64 little-endian length of the whole encoding, varint format
  version (0) and compression (0 raw, 1 a zstd frame), the body, and a u32
  little-endian CRC-32C of everything before it.  Numbers in a body are
  LEB128 varints unless said otherwise; arrays are stored column by column.
  data file table: n, the path prefix each shares with the previous
    [n - 1], suffix lengths [n], base path lengths [n], the suffixes; a
    path is relative to the database's directory.
  manifest: uuid (16 bytes), manifest kind (0 single, 1 numbered:
    `manifest.<%016x>` files hold the versions), max inline value bytes,
    max decoded node bytes, version tree arity log2 (byte), compression
    (a u32 zstd level follows 1); then a data file table, the newest
    versions (n, generation [n], root height [n] bytes, root's data file
    [n], offset [n], length [n], num keys [n], tree bytes [n], indirect
    bytes [n], commit time [n] u64) and references to version tree nodes
    of older ones (n, generation [n], data file [n], offset [n], length
    [n], generations [n], commit time [n] u64, height [n] bytes).
  version tree node: arity log2 and height (bytes), a data file table, and
    the entries of a leaf (as the manifest's versions) or of an interior
    node (as its references, without the heights).
  B-tree node: height (byte), a data file table, n, key prefix lengths
    [n - 1], key suffix lengths [n]; interior nodes then the subtree
    common prefix lengths [n], the key suffixes, each child's data file
    [n], offset [n], length [n], num keys [n], tree bytes [n], indirect
    bytes [n] (a child's keys are stored without the parent's key prefix
    and the common prefix); leaves the key suffixes, value lengths [n],
    value kinds [n] (0 inline, 1 in a data file), the data file [m] and
    offset [m] of the m values in data files, and the inline values.
  An empty tree's root has length 2**64 - 1.

The writer writes the layout without OCDBT and with uncompressed chunks
("compressor": null), and `_METADATA` beside them: the least that orbax
0.11.32 restores both with an abstract target and without one.  A save is
atomic: it is written into a temporary sibling and renamed onto its name.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import struct
import threading
import time
import uuid

import numpy as np

from cooperativeimagecaptioning_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
_EMPTY = 2 ** 64 - 1
_KEY_SEQUENCE, _KEY_DICT = 1, 2
ARRAY_TYPES = ("jax.Array", "np.ndarray")


class FormatError(ValueError):
    """A file of an `.orbax` directory is not what the format says."""


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise FormatError(f"{self.what}: truncated")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def bytes_(self, n: int) -> list:
        return list(self.raw(n))

    def u64s(self, n: int) -> list:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def end(self):
        if self.pos != len(self.data):
            raise FormatError(f"{self.what}: {len(self.data) - self.pos} "
                              "bytes after the last field")


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded manifest or node, after its magic, length
    and checksum are checked."""
    if len(data) < 18:
        raise FormatError(f"{what}: {len(data)} bytes, too short")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise FormatError(f"{what}: magic {got:#010x}, expected "
                          f"{magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise FormatError(f"{what}: length field {length}, {len(data)} "
                          "bytes read")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise FormatError(f"{what}: checksum mismatch")
    cur = _Cursor(data[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise FormatError(f"{what}: format version {version} (0 is read)")
    body = data[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise FormatError(f"{what}: compression {compression}")


def _data_file_table(cur: _Cursor) -> list:
    n = cur.varint()
    if n == 0:
        return []
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: the paths are whole already
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + cur.raw(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


class Ocdbt:
    """One OCDBT database (a directory holding `manifest.ocdbt`), read at
    its newest version."""

    def __init__(self, root: str):
        self.root = root
        self._files = {}
        self._read_manifest()

    # -- files ----------------------------------------------------------------
    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int, what: str) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise FormatError(f"{what}: [{offset}, {offset + length}) past "
                              f"the end of {rel} ({len(data)} bytes)")
        return data[offset:offset + length]

    # -- the manifest and the version tree -----------------------------------
    def _read_manifest(self):
        name = "manifest.ocdbt"
        body = decode_file(self._file(name), MANIFEST_MAGIC, name)
        cur = _Cursor(body, name)
        kind = self._config(cur)
        if kind == 1:
            numbered = [f for f in os.listdir(self.root)
                        if re.fullmatch(r"manifest\.[0-9a-f]{16}", f)]
            if not numbered:
                raise FormatError(f"{self.root}: a numbered manifest kind "
                                  "and no manifest.<n> file")
            name = max(numbered, key=lambda f: int(f[9:], 16))
            body = decode_file(self._file(name), MANIFEST_MAGIC, name)
            cur = _Cursor(body, name)
            self._config(cur)
        elif kind != 0:
            raise FormatError(f"{name}: manifest kind {kind}")
        files = _data_file_table(cur)
        self.versions = self._versions(cur, files)
        self.version_nodes = self._version_refs(cur, files, heights=True)
        cur.end()

    def _config(self, cur: _Cursor) -> int:
        cur.raw(16)  # uuid
        kind = cur.varint()
        cur.varint()  # max inline value bytes
        cur.varint()  # max decoded node bytes
        cur.raw(1)  # version tree arity log2
        if cur.varint() == 1:
            cur.raw(4)  # zstd level
        return kind

    @staticmethod
    def _versions(cur: _Cursor, files: list) -> list:
        n = cur.varint()
        gen, height = cur.varints(n), cur.bytes_(n)
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        keys = cur.varints(n)
        cur.varints(n)  # tree bytes
        cur.varints(n)  # indirect value bytes
        cur.u64s(n)  # commit times
        return [dict(generation=gen[i], height=height[i],
                     file=files[fid[i]] if length[i] != _EMPTY else None,
                     offset=off[i], length=length[i], num_keys=keys[i])
                for i in range(n)]

    @staticmethod
    def _version_refs(cur: _Cursor, files: list, heights: bool,
                      height=None) -> list:
        n = cur.varint()
        gen, fid = cur.varints(n), cur.varints(n)
        off, length, count = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.u64s(n)  # commit times
        hs = cur.bytes_(n) if heights else [height] * n
        return [dict(generation=gen[i], file=files[fid[i]], offset=off[i],
                     length=length[i], generations=count[i], height=hs[i])
                for i in range(n)]

    def generations(self) -> list:
        """Every version's generation number, oldest first, from the
        version tree's nodes and the manifest's newest versions."""
        out = []
        for ref in self.version_nodes:
            out += self._node_generations(ref)
        return out + [v["generation"] for v in self.versions]

    def _node_generations(self, ref) -> list:
        what = f"version tree node in {ref['file']}"
        body = decode_file(self._slice(ref["file"], ref["offset"],
                                       ref["length"], what),
                           VERSION_NODE_MAGIC, what)
        cur = _Cursor(body, what)
        cur.raw(1)  # arity log2
        height = cur.raw(1)[0]
        if height != ref["height"]:
            raise FormatError(f"{what}: height {height}, its reference says "
                              f"{ref['height']}")
        files = _data_file_table(cur)
        if height == 0:
            gens = [v["generation"] for v in self._versions(cur, files)]
        else:
            gens = []
            for child in self._version_refs(cur, files, heights=False,
                                            height=height - 1):
                gens += self._node_generations(child)
        cur.end()
        if len(gens) != ref["generations"] or gens[-1] != ref["generation"]:
            raise FormatError(f"{what}: {len(gens)} generations up to "
                              f"{gens[-1]}, its reference says "
                              f"{ref['generations']} up to "
                              f"{ref['generation']}")
        return gens

    # -- the B-tree ---------------------------------------------------------
    def items(self) -> dict:
        """{key: value} of the newest version."""
        out = {}
        latest = self.versions[-1] if self.versions else None
        if latest is not None and latest["file"] is not None:
            self._node(latest["file"], latest["offset"], latest["length"],
                       latest["height"], b"", out)
            if len(out) != latest["num_keys"]:
                raise FormatError(f"{self.root}: {len(out)} keys read, the "
                                  f"manifest says {latest['num_keys']}")
        return out

    def _node(self, rel, offset, length, height, prefix, out):
        what = f"B-tree node in {rel}"
        body = decode_file(self._slice(rel, offset, length, what),
                           BTREE_NODE_MAGIC, what)
        cur = _Cursor(body, what)
        got = cur.raw(1)[0]
        if got != height:
            raise FormatError(f"{what}: height {got}, its parent says "
                              f"{height}")
        files = _data_file_table(cur)
        n = cur.varint()
        shared = [0] + cur.varints(n - 1) if n else []
        suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            key = prev[:shared[i]] + cur.raw(suffix[i])
            keys.append(key)
            prev = key
        if height:
            fid, off, ln = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(n)  # num keys
            cur.varints(n)  # tree bytes
            cur.varints(n)  # indirect value bytes
            cur.end()
            for i in range(n):
                self._node(files[fid[i]], off[i], ln[i], height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        lengths, kinds = cur.varints(n), cur.varints(n)
        m = sum(1 for k in kinds if k == 1)
        fid, off = cur.varints(m), cur.varints(m)
        j = 0
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if kinds[i] == 0:
                out[key] = cur.raw(lengths[i])
            elif kinds[i] == 1:
                out[key] = self._slice(files[fid[j]], off[j], lengths[i],
                                       f"value {key!r}")
                j += 1
            else:
                raise FormatError(f"{what}: value kind {kinds[i]}")
        cur.end()


def ocdbt_items(path: str) -> dict:
    """The keys of an orbax directory's OCDBT database: its top-level
    database, or, where a save left none, the union of the per-process
    ones (`ocdbt.process_<n>/`)."""
    if os.path.isfile(os.path.join(path, "manifest.ocdbt")):
        return Ocdbt(path).items()
    out = {}
    subs = sorted(d for d in os.listdir(path)
                  if re.fullmatch(r"ocdbt\.process_\d+", d))
    if not subs:
        raise FormatError(f"{path}: use_ocdbt and no manifest.ocdbt")
    for sub in subs:
        out.update(Ocdbt(os.path.join(path, sub)).items())
    return out


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

def _dtype(name: str):
    """(the numpy dtype of the stored bytes, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def read_array(get, name: str) -> np.ndarray:
    """The zarr v2 array under `name/`; `get(key)` returns a key's bytes or
    None.  Every cell of the chunk grid is read; a missing chunk holds the
    fill value.  bfloat16 comes back as float32 (exact)."""
    raw = get(name + "/.zarray")
    if raw is None:
        raise FormatError(f"{name}/.zarray missing")
    meta = json.loads(raw)
    if meta.get("zarr_format", 2) != 2:
        raise FormatError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise FormatError(f"{name}: zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise FormatError(f"{name}: compressor {comp.get('id')!r} (zstd and "
                          "none are read)")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype, bf16 = _dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value")),
                  np.float32 if bf16 else dtype.newbyteorder("="))
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for cell in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, cell)) if cell else '0'}"
        data = get(key)
        if data is None:
            continue
        if comp is not None:
            data = zstd.decompress(data, nbytes)
        if len(data) != nbytes:
            raise FormatError(f"{key}: {len(data)} bytes, a chunk holds "
                              f"{nbytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        if bf16:
            chunk = (chunk.astype(np.uint32) << 16).view(np.float32)
        lo = [i * c for i, c in zip(cell, chunks)]
        hi = [min(b + c, s) for b, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(b, e) for b, e in zip(lo, hi))] = \
            chunk[tuple(slice(0, e - b) for b, e in zip(lo, hi))]
    return out


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def read_metadata(path: str) -> dict:
    with open(os.path.join(path, "_METADATA")) as f:
        return json.load(f)


def _getter(path: str, meta: dict):
    if meta.get("use_zarr3"):
        raise FormatError(f"{path}: the zarr3 layout is not read (the JAX "
                          "package writes zarr v2)")
    if meta.get("use_ocdbt"):
        return ocdbt_items(path).get

    def get(key):
        full = os.path.join(path, *key.split("/"))
        if not os.path.isfile(full):
            return None
        with open(full, "rb") as f:
            return f.read()
    return get


def read(path: str) -> dict:
    """The tree an `.orbax` directory holds: nested dicts (and lists, where
    `key_type` says a sequence) of numpy arrays."""
    wait_for(path)
    meta = read_metadata(path)
    get = _getter(path, meta)
    root, sequences = {}, set()
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in ARRAY_TYPES:
            raise FormatError(f"{path}: leaf {[k['key'] for k in keys]} of "
                              f"type {value.get('value_type')!r}")
        node = root
        for k, nxt in zip(keys, keys[1:]):
            node = node.setdefault(k["key"], {})
            if nxt["key_type"] == _KEY_SEQUENCE:
                sequences.add(id(node))
        if keys[0]["key_type"] == _KEY_SEQUENCE:
            sequences.add(id(root))
        name = ".".join(str(k["key"]) for k in keys)
        node[keys[-1]["key"]] = read_array(get, name)

    def finish(node):
        if not isinstance(node, dict):
            return node
        if id(node) in sequences:
            return [finish(node[k]) for k in sorted(node, key=int)]
        return {k: finish(v) for k, v in node.items()}
    return finish(root)


def _flatten(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, keys + ((str(k), _KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), _KEY_SEQUENCE),))
    else:
        yield keys, np.asarray(tree)


def _write_file(path: str, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_into(tree, path: str):
    """Write `tree` (nested dicts and lists of numpy arrays) as the files of
    an `.orbax` directory into the existing empty directory `path`."""
    meta = {}
    for keys, arr in _flatten(tree):
        name = ".".join(k for k, _ in keys)
        meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(arr.shape)}}
        d = os.path.join(path, name)
        os.mkdir(d)
        zarray = {"chunks": list(arr.shape), "compressor": None,
                  "dimension_separator": ".", "dtype": arr.dtype.str,
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": list(arr.shape), "zarr_format": 2}
        _write_file(os.path.join(d, ".zarray"), json.dumps(zarray).encode())
        if arr.size:
            _write_file(os.path.join(d, ".".join(["0"] * arr.ndim) or "0"),
                        np.ascontiguousarray(arr).tobytes())
        _fsync_dir(d)
    _write_file(os.path.join(path, "_METADATA"), json.dumps({
        "tree_metadata": meta, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}).encode())
    _fsync_dir(path)


def write(tree, path: str):
    """Write `tree` as the `.orbax` directory `path`, atomically: into a
    temporary sibling, renamed onto `path` when complete.  A previous
    directory at `path` stays whole until the new one replaces it; a write
    that fails leaves no temporary directory behind."""
    path = os.path.abspath(path)
    parent, base = os.path.split(path)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = os.path.join(parent, f".{base}.tmp-{tag}")
    os.mkdir(tmp)
    try:
        write_into(tree, tmp)
        old = None
        if os.path.lexists(path):
            old = os.path.join(parent, f".{base}.old-{tag}")
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old)


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------

_inflight_lock = threading.Lock()
_inflight = {}  # absolute path -> the thread writing it, in this process


def wait_for(path: str):
    """Wait until no write of this process to `path` is in flight (a write's
    error stays with its writer's `sync`)."""
    with _inflight_lock:
        thread = _inflight.get(os.path.abspath(path))
    if thread is not None:
        thread.join()


class AsyncWriter:
    """One background writer of `.orbax` directories, as orbax's
    asynchronous checkpointer: `save` returns once the caller's snapshot is
    handed over, the write runs on a thread of its own, `sync` waits for
    it.  One write at a time: `save` syncs first.  An error of the writer
    is raised at the next `sync` or `save`."""

    def __init__(self):
        self._thread = None
        self._error = None
        self.write_ms = None  # the last completed write's wall time

    def save(self, tree, path: str):
        """Write `tree` (host numpy arrays that no one changes afterwards:
        the caller's snapshot) to `path` in the background."""
        self.sync()
        path = os.path.abspath(path)
        thread = threading.Thread(target=self._run, args=(tree, path),
                                  name=f"orbax writer {path}")
        with _inflight_lock:
            _inflight[path] = thread
        self._thread = thread
        thread.start()

    def _run(self, tree, path):
        t0 = time.perf_counter()
        try:
            write(tree, path)
            self.write_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # handed to the owner's next sync()
            self._error = e
        finally:
            with _inflight_lock:
                if _inflight.get(path) is threading.current_thread():
                    del _inflight[path]

    def sync(self):
        """Wait for the pending write; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

