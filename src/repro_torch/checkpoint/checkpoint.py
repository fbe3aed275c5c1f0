"""Fault-tolerant checkpointing of torch tensor trees, in the JAX package's
on-disk format.

Format (``repro.checkpoint.checkpoint``): the magic ``REPRO_CKPT1``, the
SHA-256 of the compressed blob, then the blob: one msgpack payload
``{"arrays": {key: {"dtype", "shape", "data"}}, "metadata"}``, compressed
with zstandard when it is importable and with zlib (level 6) otherwise, the
codec detected from the frame header on load.  Keys are ``/``-joined paths,
dict keys in sorted order (as ``jax.tree_util`` flattens dicts) and list
indices; dtypes are numpy's names (``"float32"``, ``"bfloat16"``,
``"int32"``); data is the tensor's raw bytes.  So the port's file of a tree
is byte for byte the reference's for the same arrays and codec, and each
side loads the other's.  The payload goes through the port's own msgpack
codec (``msgpack_lite``) and the bytes through torch alone: nothing here
needs numpy's bfloat16.

Writes are crash-safe (tmp file, fsync, atomic rename).
``CheckpointManager`` keeps the newest ``keep`` checkpoints, restores the
newest valid one (corrupt files are detected by hash and skipped) and
writes in a background thread from a host snapshot.
"""

from __future__ import annotations

import hashlib
import os
import threading
import zlib
from typing import Any

import torch

from . import msgpack_lite

try:
    import zstandard
except ImportError:          # the reference's optional dep: stdlib zlib then
    zstandard = None

Params = Any

_MAGIC = b"REPRO_CKPT1"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"

# numpy's dtype names, as the reference writes them
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def _compress(data: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(data)
    return zlib.compress(data, 6)


def _decompress(blob: bytes) -> bytes:
    """Codec is detected from the frame header, so checkpoints written with
    either codec load on any host that has the matching library."""
    if blob[:4] == _ZSTD_FRAME_MAGIC:
        if zstandard is None:
            raise ValueError("checkpoint is zstd-compressed but zstandard "
                             "is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _leaves(tree: Params, path: tuple = ()):
    """(key, leaf) in ``jax.tree_util``'s order: dict keys sorted, list and
    tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield "/".join(path), tree
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(path)!r} is a "
                        f"{type(tree).__name__}, not a torch.Tensor")


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in C order (a host copy only where needed)."""
    flat = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return memoryview(flat.numpy())


def save(path: str, tree: Params, metadata: dict | None = None):
    payload = {
        "arrays": {
            key: {"dtype": _DTYPE_NAMES[leaf.dtype], "shape": list(leaf.shape),
                  "data": _raw_bytes(leaf)}
            for key, leaf in _leaves(tree)
        },
        "metadata": metadata or {},
    }
    blob = _compress(msgpack_lite.packb(payload))
    digest = hashlib.sha256(blob).digest()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(digest)
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _tensor(entry: dict) -> torch.Tensor:
    dtype, shape = _DTYPES[entry["dtype"]], entry["shape"]
    data = entry["data"]
    if not data:                       # frombuffer refuses an empty buffer
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def _unflatten_into(template: Params, arrays: dict) -> Params:
    restored = {}
    for key, leaf in _leaves(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _tensor(arrays[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        restored[key] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(template, restored)


def _rebuild(tree: Params, restored: dict, path: tuple = ()) -> Params:
    if isinstance(tree, dict):
        return {k: _rebuild(v, restored, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, restored, path + (str(i),))
                          for i, v in enumerate(tree))
    return restored["/".join(path)]


def load(path: str, template: Params):
    """Restore into the structure, dtypes and devices of ``template``.
    Raises on corruption (bad magic or hash), on a missing leaf and on a
    shape mismatch."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: bad magic")
    digest, blob = raw[len(_MAGIC):len(_MAGIC) + 32], raw[len(_MAGIC) + 32:]
    if hashlib.sha256(blob).digest() != digest:
        raise ValueError(f"{path}: content hash mismatch (corrupt)")
    try:
        decompressed = _decompress(blob)
    except zlib.error as e:
        raise ValueError(f"{path}: decompression failed ({e})") from e
    payload = msgpack_lite.unpackb(decompressed)
    return _unflatten_into(template, payload["arrays"]), payload["metadata"]


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + async writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.msgpack.zst")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and name.endswith(".msgpack.zst"):
                out.append(int(name[5:15]))
        return sorted(out)

    def save(self, step: int, tree: Params, metadata: dict | None = None):
        meta = dict(metadata or {}, step=step)
        save(self._path(step), tree, meta)
        self._gc()

    def save_async(self, step: int, tree: Params, metadata: dict | None = None):
        """Snapshot to host memory now, write in a background thread.  The
        snapshot is a copy of every leaf (``.cpu()`` of a CPU tensor is the
        same storage), so the caller may update its tensors in place while
        the writer runs."""
        host_tree = _rebuild(tree, {key: t.detach().to("cpu", copy=True)
                                    for key, t in _leaves(tree)})
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, metadata), daemon=True)
        self._thread.start()

    def _write(self, step, tree, metadata):
        try:
            self.save(step, tree, metadata)
        except BaseException as e:      # re-raised by wait()
            self._error = e

    def wait(self):
        """Join the background writer; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def restore_latest(self, template: Params):
        """Restore the newest valid checkpoint; corrupt files are skipped
        (node-failure tolerance).  Returns (tree, metadata) or None."""
        for step in reversed(self.steps()):
            try:
                return load(self._path(step), template)
            except (ValueError, KeyError, OSError):
                continue
        return None

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
