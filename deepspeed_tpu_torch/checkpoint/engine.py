"""Sharded checkpoint save / load (counterpart of
``deepspeed_tpu/checkpoint/engine.py``), in the JAX package's on-disk
layout, so a checkpoint is one format whichever package wrote it::

    <dir>/<tag>/
      checkpoint_meta.json            # format 2: leaves, client_state,
                                      # save_id, entry_crc32
      shards_p00000.<save_id>.npz     # ZIP_STORED chunk file per process
    <dir>/latest                      # the newest tag

A state is a flat ``{leaf name: tensor or array}``; leaf names are JAX
keystrs (``.params['h_0']['attn']['qkv']['kernel']``).  Each chunk is an
``.npy`` entry named ``<leaf>|<start:stop,...>`` by its global index
(``|`` alone for a scalar, stored as shape ``(1,)``); bf16 and fp8 are
stored as their uint16 / uint8 bits and re-viewed from the meta's dtype.
This process writes each leaf as one whole chunk; a reader assembles any
set of chunk rectangles, so the sliced chunks of a JAX checkpoint saved
over a mesh rebuild full leaves here.  A save gets a fresh ``save_id``
that names its shard file, written to ``.tmp`` and renamed; only files
of the meta's id are read, so an interrupted re-save of a tag fails
loudly instead of mixing two saves.  Each entry's CRC32 goes into the
meta and is checked on first read (:class:`CheckpointCorrupt`).

``save_state`` copies the state to host memory before it returns (on a
CUDA device: pinned buffers filled by non-blocking copies, then an event
waited on), so a training step that updates the parameters in place
right after an async save cannot reach the files; only the write runs
on the :class:`AsyncCheckpointWriter` thread.  Round-1 ``model_states.npz``
checkpoints (format 1) are read back.
"""

import io
import json
import os
import threading
import uuid
import zipfile
import zlib

import numpy as np
import torch

_META = "checkpoint_meta.json"
_FORMAT = 2

# meta dtype names (numpy's, as the JAX writer records them) <-> torch
TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2, "int8": torch.int8,
                "uint8": torch.uint8, "int16": torch.int16,
                "int32": torch.int32, "int64": torch.int64,
                "bool": torch.bool}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}
# dtypes numpy lacks: stored as their bits
_BITS = {torch.bfloat16: (torch.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8),
         torch.float8_e5m2: (torch.uint8, np.uint8)}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed an integrity check (CRC mismatch, truncated
    shard file, missing chunk coverage): roll back to an older intact
    tag rather than restoring partial state."""


def keystr(path):
    """A JAX keystr of a path of dict keys: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_tree(tree, prefix=""):
    """``[(name, leaf)]`` of a nested dict, keys sorted at each level (the
    JAX flatten order), names ``prefix + keystr``."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out.append((prefix + keystr(path), node))
    walk(tree, ())
    return out


def _index_key(shape):
    """The index of a whole leaf: ``'0:d0,0:d1,...'`` (``''`` for a
    scalar)."""
    return ",".join(f"0:{d}" for d in shape)


def _parse_index(key):
    if not key:
        return ()
    return tuple(slice(int(a), int(b))
                 for a, b in (p.split(":") for p in key.split(",")))


def _full_index(shape):
    return tuple(slice(0, d) for d in shape)


def _dtype_name(leaf):
    if isinstance(leaf, torch.Tensor):
        return DTYPE_NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _to_numpy(t):
    """A host tensor -> numpy, bf16 / fp8 as their bits."""
    if t.dtype in _BITS:
        view, np_bits = _BITS[t.dtype]
        return t.view(view).numpy().view(np_bits)
    return t.numpy()


def _write_npz_streaming(path, chunk_iter):
    """Write an ``.npz`` one entry at a time (``ZIP_STORED``).  Returns
    ``{entry key: crc32}``, the CRC zipfile records for the stored
    ``.npy`` bytes."""
    crcs = {}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for key, arr in chunk_iter:
            arr = np.ascontiguousarray(arr)
            if arr.ndim == 0:
                arr = arr.reshape(1)       # scalars are stored as (1,)
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, allow_pickle=False)
            z.writestr(key + ".npy", buf.getvalue())
            crcs[key] = z.getinfo(key + ".npy").CRC
    return crcs


class _Snapshot:
    """Host copies of a state's tensors, made before the save returns.
    CUDA tensors go to pinned buffers by non-blocking copies fenced by
    one event; CPU tensors are cloned."""

    def __init__(self, state):
        self.items = []
        event = None
        for name, leaf in state.items():
            if isinstance(leaf, torch.Tensor):
                src = leaf.detach()
                if src.device.type == "cuda":
                    host = torch.empty(src.shape, dtype=src.dtype,
                                       pin_memory=True)
                    host.copy_(src, non_blocking=True)
                    event = event or torch.cuda.Event()
                else:
                    host = src.clone()
                self.items.append((name, host))
            else:
                self.items.append((name, np.array(leaf)))
        if event is not None:
            event.record()
            event.synchronize()

    def chunks(self, transposed=()):
        """``(entry key, numpy)`` per leaf, one whole chunk each; a leaf
        named in ``transposed`` is written as its transpose."""
        for name, leaf in self.items:
            arr = _to_numpy(leaf) if isinstance(leaf, torch.Tensor) else leaf
            if name in transposed:
                arr = np.ascontiguousarray(arr.T)
            yield f"{name}|{_index_key(arr.shape)}", arr


def save_state(path, state, client_state=None, async_write=False,
               on_done=None, transposed=()):
    """Save ``state`` (``{leaf name: tensor or array}``) under ``path``.
    Returns an :class:`AsyncCheckpointWriter` when ``async_write`` (call
    ``wait()``), else None.  ``on_done`` runs once the shard file is
    durable (the engine flips ``latest`` there).  The 2-D leaves named in
    ``transposed`` are written transposed (the port's ``[out, in]``
    weights as the JAX ``[in, out]`` kernels); the meta records the
    written shapes."""
    os.makedirs(path, exist_ok=True)
    save_id = uuid.uuid4().hex[:12]
    snap = _Snapshot(state)
    transposed = frozenset(transposed)
    leaves = {name: {"shape": list(leaf.shape[::-1] if name in transposed
                                   else leaf.shape),
                     "dtype": _dtype_name(leaf)}
              for name, leaf in snap.items}
    meta = {"format": _FORMAT, "process_count": 1, "save_id": save_id,
            "leaves": leaves, "client_state": client_state or {}}
    tmp_meta = os.path.join(path, _META + ".tmp")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(tmp_meta, os.path.join(path, _META))
    shard_file = os.path.join(path, f"shards_p00000.{save_id}.npz")

    def write():
        crcs = _write_npz_streaming(shard_file + ".tmp",
                                    snap.chunks(transposed))
        os.replace(shard_file + ".tmp", shard_file)
        _merge_meta_crcs(path, crcs)
        # reclaim the shard files of earlier saves of this tag
        for fn in os.listdir(path):
            if fn.startswith("shards_p") and fn.endswith(".npz") and \
                    save_id not in fn:
                try:
                    os.remove(os.path.join(path, fn))
                except OSError:
                    pass
        if on_done is not None:
            on_done()

    if async_write:
        writer = AsyncCheckpointWriter(write)
        writer.start()
        return writer
    write()
    return None


def _merge_meta_crcs(path, crcs):
    """Fold the entry CRCs into ``checkpoint_meta.json`` (atomic)."""
    meta_f = os.path.join(path, _META)
    with open(meta_f) as fh:
        meta = json.load(fh)
    merged = dict(meta.get("entry_crc32", {}))
    merged.update({k: int(v) for k, v in crcs.items()})
    meta["entry_crc32"] = merged
    tmp = meta_f + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    os.replace(tmp, meta_f)


def _shard_files(path, meta):
    """The shard files of the meta's save (the JAX ``_ChunkIndex`` rule:
    another ``save_id`` or a process index past the count is stale)."""
    save_id = (meta or {}).get("save_id")
    nprocs = (meta or {}).get("process_count")
    out = []
    for fn in sorted(os.listdir(path)):
        if not (fn.startswith("shards_p") and fn.endswith(".npz")):
            continue
        pidx, _, fid = fn[len("shards_p"):-len(".npz")].partition(".")
        if save_id is not None and fid != save_id:
            continue
        if nprocs is not None and int(pidx) >= nprocs:
            continue
        out.append(fn)
    return out


def verify_checkpoint(path):
    """Integrity-check one tag directory without restoring it (the JAX
    ``verify_checkpoint``, ``:330``).  Returns ``(ok, problems)``: the
    meta parses; every process's shard file of the meta's ``save_id`` is
    there; each is a valid zip whose members match their zip CRCs; the
    meta's ``entry_crc32`` matches the members; the chunks cover every
    element of every leaf."""
    problems = []
    meta_f = os.path.join(path, _META)
    if not os.path.isdir(path):
        return False, [f"no such checkpoint directory: {path}"]
    if not os.path.exists(meta_f):
        if os.path.exists(os.path.join(path, "model_states.npz")):
            return True, []     # format 1: no integrity metadata
        return False, [f"missing {_META}"]
    try:
        with open(meta_f) as fh:
            meta = json.load(fh)
    except (json.JSONDecodeError, OSError) as e:
        return False, [f"unreadable {_META}: {e}"]
    nprocs = int(meta.get("process_count", 1))
    meta_crcs = {k: int(v) for k, v in meta.get("entry_crc32", {}).items()}
    files = _shard_files(path, dict(meta, process_count=None))
    if len(files) < nprocs:
        problems.append(f"only {len(files)}/{nprocs} shard files present "
                        f"for save {meta.get('save_id')}")
    entry_crcs = {}
    for fn in files:
        try:
            with zipfile.ZipFile(os.path.join(path, fn)) as z:
                bad = z.testzip()
                if bad is not None:
                    problems.append(f"{fn}: member {bad} fails CRC")
                for info in z.infolist():
                    key = info.filename[:-len(".npy")] \
                        if info.filename.endswith(".npy") else info.filename
                    entry_crcs[key] = info.CRC
        except (zipfile.BadZipFile, OSError) as e:
            problems.append(f"{fn}: unreadable/truncated zip ({e})")
    for key, want in meta_crcs.items():
        have = entry_crcs.get(key)
        if have is None:
            problems.append(f"meta entry {key} missing from shard files")
        elif have != want:
            problems.append(f"entry {key}: crc32 {have:#010x} != meta "
                            f"{want:#010x}")
    for name, info in (meta.get("leaves") or {}).items():
        shape = tuple(info.get("shape", ()))
        want = int(np.prod(shape)) if shape else 1
        filled = 0
        for key in entry_crcs:
            leaf, _, idx = key.rpartition("|")
            if leaf != name:
                continue
            filled += int(np.prod([s.stop - s.start
                                   for s in _parse_index(idx)])) if idx else 1
        if filled < want:
            problems.append(f"leaf {name}: chunks cover {filled}/{want} "
                            "elements")
    return not problems, problems


class AsyncCheckpointWriter:
    """A background-thread writer; :meth:`wait` joins it and raises what
    the write raised."""

    def __init__(self, fn):
        self._err = None

        def run():
            try:
                fn()
            except BaseException as e:      # surfaced on wait()
                self._err = e
        self._thread = threading.Thread(target=run, daemon=True)

    def start(self):
        self._thread.start()

    def wait(self):
        self._thread.join()
        if self._err is not None:
            raise self._err


class _ChunkIndex:
    """Every chunk rectangle of a checkpoint's shard files, read one zip
    entry at a time (the JAX ``_ChunkIndex``, ``:452-585``)."""

    def __init__(self, path):
        self.path = path
        self.by_leaf = {}      # name -> [(index key, file, zip key)]
        self._files = {}
        self._verified = set()
        self.meta = None
        meta_f = os.path.join(path, _META)
        if os.path.exists(meta_f):
            with open(meta_f) as fh:
                self.meta = json.load(fh)
        for fn in _shard_files(path, self.meta):
            npz = np.load(os.path.join(path, fn), allow_pickle=False)
            self._files[fn] = npz
            for zkey in npz.files:
                name, _, idx = zkey.rpartition("|")
                self.by_leaf.setdefault(name, []).append((idx, fn, zkey))

    def saved_shape(self, name):
        leaves = (self.meta or {}).get("leaves", {})
        if name in leaves:
            return tuple(leaves[name]["shape"])
        stops = None
        for idx, _, _ in self.by_leaf[name]:
            ends = [s.stop for s in _parse_index(idx)]
            stops = ends if stops is None else \
                [max(a, b) for a, b in zip(stops, ends)]
        return tuple(stops or ())

    def saved_dtype(self, name):
        info = (self.meta or {}).get("leaves", {}).get(name)
        return None if info is None else info.get("dtype")

    def read(self, fn, zkey):
        """One entry, its bytes checked against the meta's CRC32 on first
        read."""
        crcs = (self.meta or {}).get("entry_crc32") or {}
        want = crcs.get(zkey)
        if want is not None and (fn, zkey) not in self._verified:
            try:
                raw = self._files[fn].zip.read(zkey + ".npy")
            except zipfile.BadZipFile as e:      # the zip's own CRC
                raise CheckpointCorrupt(f"checkpoint entry {zkey} in {fn}: "
                                        f"{e}; roll back to an intact "
                                        "tag") from e
            have = zlib.crc32(raw)
            if have != int(want):
                raise CheckpointCorrupt(
                    f"checkpoint entry {zkey} in {fn}: crc32 {have:#010x} "
                    f"!= recorded {int(want):#010x} — shard data corrupt; "
                    "roll back to an intact tag")
            self._verified.add((fn, zkey))
            return np.lib.format.read_array(io.BytesIO(raw),
                                            allow_pickle=False)
        return self._files[fn][zkey]

    def assemble(self, name, out_index=None):
        """Leaf ``name`` (or its sub-array ``out_index``) as numpy in its
        saved dtype (bf16 / fp8 as their bits: see :func:`to_torch`),
        from whatever chunk rectangles overlap it."""
        shape = self.saved_shape(name)
        out_index = out_index or _full_index(shape)
        out_shape = tuple(sl.stop - sl.start for sl in out_index)
        out, filled = None, 0
        for idx_key, fn, zkey in self.by_leaf[name]:
            cidx = _parse_index(idx_key)
            chunk = None
            if not out_index:           # a scalar, stored as (1,)
                chunk = self.read(fn, zkey)
                return chunk.reshape(())
            inter = []
            for o, c in zip(out_index, cidx):
                lo, hi = max(o.start, c.start), min(o.stop, c.stop)
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi))
            if inter is None:
                continue
            chunk = self.read(fn, zkey)
            if out is None:
                out = np.empty(out_shape, chunk.dtype)
            dst = tuple(slice(lo - o.start, hi - o.start)
                        for (lo, hi), o in zip(inter, out_index))
            src = tuple(slice(lo - c.start, hi - c.start)
                        for (lo, hi), c in zip(inter, cidx))
            out[dst] = chunk[src]
            filled += int(np.prod([hi - lo for lo, hi in inter]))
        want = int(np.prod(out_shape))
        if filled < want:
            raise ValueError(f"checkpoint chunks cover {filled}/{want} "
                             f"elements of {name}{out_index} — missing "
                             "shard files?")
        return out

    def close(self):
        for npz in self._files.values():
            npz.close()


def to_torch(arr, dtype_name):
    """A loaded numpy leaf -> a tensor of the saved dtype (bf16 / fp8
    re-viewed from their bits)."""
    dtype = TORCH_DTYPES.get(dtype_name) if dtype_name else None
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype in _BITS and t.dtype != dtype:
        return t.view(_BITS[dtype][0]).view(dtype)
    return t


def _load_format1(path, target, prefix):
    data = np.load(os.path.join(path, "model_states.npz"),
                   allow_pickle=False)
    out = {}
    for name, spec in target.items():
        key = prefix + name
        if key not in data:
            raise KeyError(f"checkpoint missing entry {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(_shape(spec)):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs target {_shape(spec)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _shape(spec):
    return tuple(spec.shape) if hasattr(spec, "shape") else tuple(spec)


def load_subtree(path, target, prefix=""):
    """``{name: tensor}`` for every ``name`` of ``target`` (``{name:
    tensor or shape}``): leaf ``prefix + name``, in its saved dtype.  A
    missing leaf raises KeyError, a shape that is not the target's
    ValueError."""
    if not os.path.exists(os.path.join(path, _META)):
        return _load_format1(path, target, prefix)
    chunks = _ChunkIndex(path)
    try:
        out = {}
        for name, spec in target.items():
            key = prefix + name
            if key not in chunks.by_leaf:
                raise KeyError(f"checkpoint missing entry {key}")
            saved = chunks.saved_shape(key)
            if tuple(saved) != _shape(spec):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{saved} vs target {_shape(spec)}")
            out[name] = to_torch(chunks.assemble(key),
                                 chunks.saved_dtype(key))
        return out
    finally:
        chunks.close()


def read_client_state(path):
    meta_f = os.path.join(path, _META)
    if os.path.exists(meta_f):
        with open(meta_f) as fh:
            return json.load(fh).get("client_state", {})
    cs = os.path.join(path, "client_state.json")
    if os.path.exists(cs):
        with open(cs) as fh:
            return json.load(fh)
    return {}


def load_state(path, target):
    """``(state, client_state)``: every leaf of ``target`` restored."""
    return load_subtree(path, target), read_client_state(path)


def consolidate(path, out_file, prefix=".params", dtype=np.float32):
    """``zero_to_fp32`` (the JAX ``consolidate``, ``:675``): the leaves
    under ``prefix`` merged into one ``.npz`` in ``dtype``, one leaf in
    memory at a time, in the meta's (tree) order and under the same
    names.  A ZeRO-Offload fp32 master (``host_optim_states.npz``, JAX
    checkpoints) is preferred where present."""
    if not os.path.exists(os.path.join(path, _META)) and \
            os.path.exists(os.path.join(path, "model_states.npz")):
        with np.load(os.path.join(path, "model_states.npz"),
                     allow_pickle=False) as d:
            _write_npz_streaming(out_file, ((k, d[k].astype(dtype))
                                            for k in d.files
                                            if k.startswith(prefix)))
        return out_file
    chunks = _ChunkIndex(path)
    master_npz = None
    try:
        source = chunks.meta["leaves"] if chunks.meta is not None \
            else chunks.by_leaf
        names = [n for n in source if n.startswith(prefix)]
        if not names:
            raise ValueError(f"no leaves under {prefix!r} in {path}")
        master_of = {}
        host_opt = os.path.join(path, "host_optim_states.npz")
        if os.path.exists(host_opt):
            master_npz = np.load(host_opt, allow_pickle=False)
            n_master = sum(1 for k in master_npz.files
                           if k.startswith("master_"))
            if "leaf_names" in master_npz.files:
                known = set(names)
                master_of = {str(n): f"master_{i}" for i, n in
                             enumerate(master_npz["leaf_names"])
                             if str(n) in known}
            elif n_master == len(names):
                master_of = {n: f"master_{i}" for i, n in enumerate(names)}

        def leaf_iter():
            for name in names:
                shape = chunks.saved_shape(name)
                if name in master_of:
                    flat = master_npz[master_of[name]]
                    if flat.size != int(np.prod(shape)):
                        raise ValueError(
                            f"host master entry {master_of[name]} has "
                            f"{flat.size} elements but leaf {name} has "
                            f"shape {shape}")
                    yield name, flat.reshape(shape).astype(dtype)
                else:
                    t = to_torch(chunks.assemble(name),
                                 chunks.saved_dtype(name))
                    yield name, t.float().numpy().astype(dtype) \
                        if t.dtype in _BITS else t.numpy().astype(dtype)
        _write_npz_streaming(out_file, leaf_iter())
    finally:
        if master_npz is not None:
            master_npz.close()
        chunks.close()
    return out_file
