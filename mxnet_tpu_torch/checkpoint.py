"""Checkpoints with integrity manifests (counterpart of
``mxnet_tpu/checkpoint.py``).

Two layers, as in the JAX package:

* :func:`save_pytree` / :func:`load_pytree` — a tree of dicts and lists
  whose leaves are tensors, Python numbers, strings or None, written as a
  directory: ``tree.json`` (the structure, each tensor's dtype and shape)
  and one file of raw little-endian bytes per tensor, named by its path
  in the tree (``params/p0.bin``).  Nothing is pickled.  bfloat16 is
  written as the bits of a same-width integer view.
* :class:`TrainStepCheckpoint` — binds a
  :class:`~mxnet_tpu_torch.executor.CompiledTrainStep`: parameters, the
  net's other tensors (``aux``: frozen parameters and buffers, BatchNorm's
  moving statistics), optimizer states and the step counter, under the
  JAX package's positional layout (``params/p{i}``, ``aux/a{i}``,
  ``opt_state/p{i}``, ``num_update``).  :meth:`~TrainStepCheckpoint.restore`
  writes every tensor back **in place** (``copy_``), so a step's CUDA
  graph keeps its addresses and the next step replays with no new
  capture.  A step with ZeRO-sharded optimizer states stores each state
  at its parameter's global shape (gathered from the shards), so a
  restore onto another ``dp`` only re-slices: global shapes are
  mesh-independent.
* :func:`save_sharded_optimizer` / :func:`load_sharded_optimizer` — a
  kvstore's ZeRO-sharded optimizer state (``kvstore/sharded.py``): each
  bucket's flat slot buffers at their save-time padding, ``meta.json``
  with the JAX package's keys (``dp``, ``signatures``, ``none``,
  ``counts``, ``num_update``); the load re-partitions for the mesh
  entered now.

Every directory carries the manifest :data:`MANIFEST_NAME`: size and
sha256 of each file, written last and atomically, so a torn or corrupt
checkpoint raises :class:`CheckpointCorruptError` naming the file instead
of loading garbage.

Deliberate difference: the on-disk format is the port's own (the JAX
package writes orbax trees).  A JAX checkpoint does not load into the
port, nor the reverse; the layout names, ``meta.json`` and the manifest
are the same.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .base import MXNetError, dtype_torch

__all__ = ["save_pytree", "load_pytree", "TrainStepCheckpoint",
           "save_sharded_optimizer", "load_sharded_optimizer",
           "CheckpointCorruptError", "write_manifest", "verify_manifest",
           "MANIFEST_NAME"]

TREE_NAME = "tree.json"


class CheckpointCorruptError(MXNetError):
    """A checkpoint failed integrity verification — a truncated file, a
    hash mismatch against the manifest sidecar, or an unparseable sidecar.
    The message names the offending file; the load never deserializes the
    garbage."""


#: integrity sidecar written inside every protected checkpoint directory
MANIFEST_NAME = "mxtpu-manifest.json"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_manifest(path: str, sidecars: Dict[str, str] = None) -> str:
    """Write the integrity manifest for a checkpoint directory: size +
    sha256 of every file under `path` (the manifest itself excluded), plus
    optional out-of-tree `sidecars` ({label: filepath}).  Written LAST and
    atomically, so its presence certifies a complete write — a torn
    checkpoint is one with no (or a failing) manifest."""
    path = os.path.abspath(path)
    files = {}
    for root, _dirs, names in os.walk(path):
        for name in sorted(names):
            if root == path and name == MANIFEST_NAME:
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            files[rel] = {"bytes": os.path.getsize(full),
                          "sha256": _sha256_file(full)}
    manifest = {"version": 1, "files": files}
    if sidecars:
        manifest["sidecars"] = {
            label: {"path": os.path.basename(p),
                    "bytes": os.path.getsize(p),
                    "sha256": _sha256_file(p)}
            for label, p in sidecars.items()}
    out = os.path.join(path, MANIFEST_NAME)
    _atomic_write_json(out, manifest)
    return out


def _verify_one(full: str, rel: str, want) -> None:
    if not os.path.exists(full):
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} listed in the manifest is missing "
            f"({full})")
    size = os.path.getsize(full)
    if size != int(want["bytes"]):
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} is truncated/resized: {size} bytes on "
            f"disk vs {want['bytes']} in the manifest ({full})")
    got = _sha256_file(full)
    if got != want["sha256"]:
        raise CheckpointCorruptError(
            f"checkpoint file {rel!r} fails its manifest hash "
            f"(sha256 {got[:12]}… != {want['sha256'][:12]}…) ({full})")


def verify_manifest(path: str, required: bool = False,
                    sidecar_dir: Optional[str] = None) -> bool:
    """Verify a checkpoint directory against its manifest sidecar.  Returns
    False when no manifest exists and ``required`` is False; raises
    :class:`CheckpointCorruptError` naming the offending file on any
    truncation/mismatch."""
    path = os.path.abspath(path)
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        if required:
            raise CheckpointCorruptError(
                f"checkpoint {path} has no {MANIFEST_NAME} — the write never "
                "completed (torn) or predates integrity manifests")
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {mpath} is unreadable: {e}") from e
    for rel, want in manifest.get("files", {}).items():
        _verify_one(os.path.join(path, rel), rel, want)
    for label, want in manifest.get("sidecars", {}).items():
        base = sidecar_dir or os.path.dirname(path)
        _verify_one(os.path.join(base, want["path"]),
                    f"{label} ({want['path']})", want)
    return True


# ---------------------------------------------------------------------------
# the port's tree format
# ---------------------------------------------------------------------------
def _key(k) -> str:
    k = str(k)
    if not k or k in (".", "..") or "/" in k or os.sep in k:
        raise MXNetError(f"checkpoint key {k!r} is not a plain name")
    return k


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a host numpy array (bfloat16 through its
    int16 view: numpy has no bfloat16)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _encode(node, rel: str, root: str, files: list):
    if isinstance(node, dict):
        return {"dict": {_key(k): _encode(v, f"{rel}{_key(k)}/", root, files)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"list": [_encode(v, f"{rel}{i}/", root, files)
                         for i, v in enumerate(node)]}
    if isinstance(node, torch.Tensor):
        name = rel.rstrip("/") + ".bin"
        files.append((name, node))
        return {"tensor": name, "dtype": str(node.dtype).replace("torch.", ""),
                "shape": list(node.shape)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    if isinstance(node, np.generic):
        return {"value": node.item()}
    raise MXNetError(f"checkpoint leaf of type {type(node).__name__} at "
                     f"{rel!r}: only tensors, numbers, strings and None")


def save_pytree(path: str, tree: Any, force: bool = False,
                manifest: bool = True) -> str:
    """Write a tree of tensors (device tensors are copied to the host) plus
    an integrity manifest (``manifest=False`` skips it — callers that add
    their own files first write the manifest themselves as the final
    step).

    ``force=True`` DELETES an existing directory at `path` before writing —
    opt in explicitly; the default refuses to clobber."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not force:
            raise MXNetError(f"checkpoint path {path} exists; pass "
                             "force=True to overwrite")
        shutil.rmtree(path)
    os.makedirs(path)
    files: list = []
    index = _encode(tree, "", path, files)
    for name, t in files:
        full = os.path.join(path, name)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(memoryview(_host_bytes(t)).cast("B"))
    _atomic_write_json(os.path.join(path, TREE_NAME),
                       {"format": "mxnet_tpu_torch.pytree", "version": 1,
                        "tree": index})
    if manifest:
        write_manifest(path)
    return path


def _read_tensor(path: str, desc: dict, like) -> torch.Tensor:
    full = os.path.join(path, desc["tensor"])
    dt = dtype_torch(desc["dtype"], narrow=False)
    shape = tuple(desc["shape"])
    raw_dt = torch.int16 if dt == torch.bfloat16 else dt
    n = int(np.prod(shape, dtype=np.int64))
    width = torch.empty((), dtype=raw_dt).element_size()
    if not os.path.exists(full) or os.path.getsize(full) != n * width:
        size = os.path.getsize(full) if os.path.exists(full) else "no"
        raise CheckpointCorruptError(
            f"checkpoint file {desc['tensor']!r} holds {size} bytes, not the "
            f"{n * width} its {desc['dtype']}{list(shape)} needs ({full})")
    np_dt = torch.empty((), dtype=raw_dt).numpy().dtype
    arr = np.fromfile(full, dtype=np_dt, count=n).reshape(shape)
    t = torch.from_numpy(arr)
    if dt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def _decode(node, path: str, like):
    if "dict" in node:
        return {k: _decode(v, path, like.get(k) if isinstance(like, dict)
                           else None) for k, v in node["dict"].items()}
    if "list" in node:
        return [_decode(v, path, like[i] if isinstance(like, (list, tuple))
                        and i < len(like) else None)
                for i, v in enumerate(node["list"])]
    if "tensor" in node:
        return _read_tensor(path, node, like)
    return node["value"]


def load_pytree(path: str, template: Optional[Any] = None,
                verify: bool = True) -> Any:
    """Read a tree back (lists for sequences).  Tensors land on the CPU,
    or on the device and in the dtype of the tensor at the same place in
    ``template``.  When the directory carries an integrity manifest it is
    verified first — a truncated or bit-flipped file raises
    :class:`CheckpointCorruptError` naming it.  Callers that already ran
    :func:`verify_manifest` pass ``verify=False`` so a large checkpoint is
    not hashed twice."""
    path = os.path.abspath(path)
    if verify:
        verify_manifest(path)
    try:
        with open(os.path.join(path, TREE_NAME)) as f:
            index = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint index {os.path.join(path, TREE_NAME)} is "
            f"unreadable: {e}") from e
    return _decode(index["tree"], path, template)


# ---------------------------------------------------------------------------
# ZeRO-sharded optimizer state (kvstore/sharded.py engines)
# ---------------------------------------------------------------------------
def _sig_to_json(sig):
    """Bucket signature ((dtype, nslots), (sk, shape), ...) -> json."""
    return [[sig[0][0], sig[0][1]]] + [[sk, list(shape)]
                                       for sk, shape in sig[1:]]


def _sig_from_json(enc):
    return ((enc[0][0], int(enc[0][1])),) + tuple(
        (sk, tuple(int(d) for d in shape)) for sk, shape in enc[1:])


def _sig_payload_elems(sig) -> int:
    """Unpadded element count of a bucket: the layout its signature
    records (the padding past it is zeros, whose updates are zero, so a
    re-partition strips it and pads again freely)."""
    return sum(math.prod(shape) for _sk, shape in sig[1:])


def _listify_state(shards):
    """A list of position trees (each None, a tensor or a tuple) -> the
    checkpoint's form: each slot's shards joined into its flat buffer."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(first.device) for t in shards])
    return [_listify_state([s[i] for s in shards])
            for i in range(len(first))]


def _rewrap_state(raw, n_payload: int, devices):
    """Saved flat buffers -> position trees for the mesh entered now:
    the save-time padding stripped, padded again to a multiple of this
    ``dp``, split in shards on their positions' devices."""
    dp = len(devices)
    if isinstance(raw, (list, tuple)):
        per = [_rewrap_state(r, n_payload, devices) for r in raw]
        return [tuple(p[r] for p in per) for r in range(dp)]
    flat = raw[:n_payload]
    pad = (-n_payload) % dp
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return [c.to(d).clone() for c, d in zip(flat.chunk(dp), devices)]


def save_sharded_optimizer(path: str, store, force: bool = False) -> str:
    """Write a kvstore's ZeRO-sharded optimizer state: each bucket's slot
    buffers (the positions' shards joined, save-time padding kept) and
    ``meta.json`` with the bucket signatures, the save-time ``dp`` and the
    optimizer's per-key update counts (Adam's bias correction resumes from
    the true step, the contract of ``Updater.get_states``).

    Torn-write hardening: the tree and ``meta.json`` are written into a
    temporary directory, the manifest last, and one ``os.replace``
    publishes it.  An existing checkpoint at ``path`` is moved aside only
    after the new one is complete (never deleted first), so a crash at any
    point leaves a loadable checkpoint, the old one or the new one.  The
    ``.meta.json`` beside the directory is an unverified copy for tools;
    the one that counts lives inside the tree."""
    engine = getattr(store, "_shard_engine", None)
    if engine is None or not engine._states:
        raise MXNetError("no sharded optimizer state on this kvstore — "
                         "sharded training has not stepped yet")
    opt = store._optimizer
    tree, sigs, none_idx = {}, [], []
    for i, (sig, st) in enumerate(engine._states.items()):
        sigs.append(_sig_to_json(sig))
        if st is None or st[0] is None:
            none_idx.append(i)
        else:
            tree[f"s{i}"] = _listify_state(st)
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise MXNetError(f"checkpoint path {path} exists; pass force=True "
                         "to overwrite")
    tmp = f"{path}.tmp-{os.getpid()}"
    save_pytree(tmp, tree or {"empty": torch.zeros(1)}, force=True,
                manifest=False)
    meta = {"dp": engine.dp, "signatures": sigs, "none": none_idx,
            "counts": [[k, v] for k, v in opt._index_update_count.items()],
            "num_update": opt.num_update}
    _atomic_write_json(os.path.join(tmp, "meta.json"), meta)
    write_manifest(tmp)
    aside = None
    if os.path.exists(path):
        aside = f"{path}.old-{os.getpid()}"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(path, aside)
    os.replace(tmp, path)
    if aside is not None:
        shutil.rmtree(aside)
    _atomic_write_json(path + ".meta.json", meta)
    return path


def load_sharded_optimizer(path: str, store) -> None:
    """Restore a :func:`save_sharded_optimizer` checkpoint onto ``store``,
    re-partitioned for the mesh entered now: when ``dp`` changed, each
    slot buffer is stripped of its save-time padding and padded and split
    again for the new axis (the layout is the signature's, so each shard
    lands where the new partition needs it).

    The integrity manifest is required and verified (the shards and the
    ``meta.json`` inside the tree): a torn save, a truncated shard or a
    tampered sidecar raises :class:`CheckpointCorruptError` naming the
    file."""
    from .kvstore.sharded import ShardedOptimizerEngine, axis_devices
    from .parallel.mesh import default_mesh
    if store._optimizer is None:
        raise MXNetError("set_optimizer() before load_sharded_optimizer "
                         "(the restored slots belong to the optimizer)")
    path = os.path.abspath(path)
    verify_manifest(path, required=True)
    meta_path = os.path.join(path, "meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"sharded-optimizer sidecar {meta_path} is unreadable: {e}"
        ) from e
    tree = load_pytree(path, verify=False)
    mesh = default_mesh()
    devices = axis_devices(mesh)
    device = next(iter(store._store.values()))._data.device \
        if store._store else devices[0]
    engine = getattr(store, "_shard_engine", None)
    if engine is None:
        engine = store._shard_engine = ShardedOptimizerEngine(store)
    engine._mesh = mesh
    engine._states.clear()
    none_idx = set(meta.get("none", ()))
    for i, enc in enumerate(meta["signatures"]):
        sig = _sig_from_json(enc)
        if i in none_idx:
            engine._states[sig] = [None] * len(devices)
        else:
            raw = _to_device(tree[f"s{i}"], device)
            engine._states[sig] = _rewrap_state(
                raw, _sig_payload_elems(sig), devices)
    opt = store._optimizer
    opt._index_update_count.clear()
    for k, v in meta.get("counts", ()):
        opt._index_update_count[k] = int(v)
    opt.num_update = int(meta.get("num_update", opt.num_update))


def _to_device(node, device):
    if isinstance(node, list):
        return [_to_device(n, device) for n in node]
    return node.to(device)


# ---------------------------------------------------------------------------
# a training step's state
# ---------------------------------------------------------------------------
def _listify(state, keep: Callable):
    """An optimizer state (None, a tensor, a tuple of them) in the
    checkpoint's list form."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return keep(state)
    return [_listify(s, keep) for s in state]


def _copy_into(live, saved, where: str) -> None:
    if live is None:
        return
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or \
                tuple(saved.shape) != tuple(live.shape):
            raise MXNetError(
                f"checkpoint {where}: saved "
                f"{getattr(saved, 'shape', type(saved).__name__)} does not "
                f"fit the step's {tuple(live.shape)}")
        with torch.no_grad():
            live.copy_(saved)
        return
    if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
        raise MXNetError(f"checkpoint {where}: the optimizer state's "
                         "structure does not match the step's")
    for i, (a, b) in enumerate(zip(live, saved)):
        _copy_into(a, b, f"{where}/{i}")


class TrainStepCheckpoint:
    """Checkpoint binding for a ``CompiledTrainStep``: parameters, the
    net's other tensors, optimizer states and the step counter."""

    def __init__(self, step):
        self._step = step

    def _state_tree(self, leaf_map: Optional[Callable] = None) -> dict:
        """Keys are POSITIONAL (p0, p1, ...), so a checkpoint from one net
        instance restores into another of the same architecture whatever
        its prefixes.  ``leaf_map`` transforms every tensor (identity by
        default): the async checkpointer captures device copies through it,
        so this is the one definition of the layout."""
        s = self._step
        keep = leaf_map or (lambda t: t)
        return {
            "params": {f"p{i}": keep(p) for i, p in enumerate(s._learnable)},
            "aux": {f"a{i}": keep(t) for i, t in enumerate(s._aux)},
            "opt_state": {f"p{i}": _listify(st, keep)
                          for i, st in enumerate(s.optimizer_states())},
            "num_update": int(s._num_update),
        }

    def save(self, path: str, overwrite: bool = True) -> str:
        """Write the step state; ``overwrite=True`` (the usual
        latest-checkpoint pattern) replaces an existing directory."""
        return save_pytree(path, self._state_tree(), force=overwrite)

    def restore(self, path: str, verify: bool = True) -> None:
        """Copy the saved state into the step's live tensors in place (no
        tensor moves, so its graphs replay without a new capture) and set
        its step counter."""
        s = self._step
        restored = load_pytree(path, self._state_tree(), verify=verify)
        for part, live in (("params", s._learnable), ("aux", s._aux)):
            if len(restored.get(part, {})) != len(live):
                raise MXNetError(
                    f"checkpoint {path}: {len(restored.get(part, {}))} "
                    f"{part} saved, the step has {len(live)}")
        for i, p in enumerate(s._learnable):
            _copy_into(p, restored["params"][f"p{i}"], f"params/p{i}")
        for i, t in enumerate(s._aux):
            _copy_into(t, restored["aux"][f"a{i}"], f"aux/a{i}")
        states = s.optimizer_states()
        for i, st in enumerate(states):
            _copy_into(st, restored["opt_state"][f"p{i}"], f"opt_state/p{i}")
        if s._zero is not None:
            s.load_optimizer_states(states)
        s._num_update = int(restored["num_update"])
