"""The local, sha1-checked store of pretrained weights (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``, same files).

The store is a directory (``root``, default ``$MXNET_HOME/models``, else
``~/.mxnet/models``) holding ``{name}-{short_hash}.params`` files and a
``manifest.json`` that records each model's sha1 and file.
:func:`publish_model_file` installs a ``.params`` file (a
``save_parameters`` file of either package) under its name;
:func:`get_model_file` resolves a name and verifies the file's sha1
before it is loaded, raising on a missing model or a corrupted file.  The
format is the JAX package's, so a model one package publishes loads in
the other.  Nothing here reaches the network: a missing model names
``publish_model_file`` as the way to install it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional

from ...base import env

__all__ = ["get_model_file", "publish_model_file", "purge", "short_hash",
           "list_models"]

_MANIFEST = "manifest.json"


def _default_root() -> str:
    home = env.MXNET_HOME or os.path.join(os.path.expanduser("~"), ".mxnet")
    return os.path.join(home, "models")


def _root(root: Optional[str]) -> str:
    return os.path.expanduser(root or _default_root())


def _sha1(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _load_manifest(root: str) -> Dict[str, Dict[str, str]]:
    p = os.path.join(root, _MANIFEST)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def _save_manifest(root: str, manifest: Dict[str, Dict[str, str]]) -> None:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(root, _MANIFEST))


def short_hash(name: str, root: Optional[str] = None) -> str:
    """The first 8 hex digits of ``name``'s recorded sha1."""
    root = _root(root)
    manifest = _load_manifest(root)
    if name not in manifest:
        raise ValueError(f"model {name!r} is not in the local weight store "
                         f"at {root}")
    return manifest[name]["sha1"][:8]


def get_model_file(name: str, root: Optional[str] = None) -> str:
    """The path of ``name``'s ``.params`` file in the store, its sha1
    verified; raises ``IOError`` for a model not published, a file
    missing, or a checksum that differs."""
    root = _root(root)
    manifest = _load_manifest(root)
    if name not in manifest:
        raise IOError(
            f"model {name!r} not found in the local weight store at {root}. "
            "The store is local: install weights with "
            "mxnet_tpu_torch.gluon.model_zoo.model_store.publish_model_file"
            "(name, params_path, root=...) first.")
    entry = manifest[name]
    path = os.path.join(root, entry["file"])
    if not os.path.exists(path):
        raise IOError(f"weight file {entry['file']} for model {name!r} is "
                      f"missing from {root} (manifest is stale; re-publish)")
    actual = _sha1(path)
    if actual != entry["sha1"]:
        raise IOError(f"checksum mismatch for {path}: expected "
                      f"{entry['sha1']}, got {actual}. The file is "
                      "corrupted; re-publish it.")
    return path


def publish_model_file(name: str, params_path: str,
                       root: Optional[str] = None) -> str:
    """Install ``params_path`` into the store as
    ``{name}-{short_hash}.params``, record its sha1 (replacing an older
    file of ``name``) and return the stored path."""
    root = _root(root)
    os.makedirs(root, exist_ok=True)
    sha1 = _sha1(params_path)
    fname = f"{name}-{sha1[:8]}.params"
    dest = os.path.join(root, fname)
    if os.path.abspath(params_path) != os.path.abspath(dest):
        shutil.copyfile(params_path, dest)
    manifest = _load_manifest(root)
    stale = manifest.get(name)
    manifest[name] = {"sha1": sha1, "file": fname}
    _save_manifest(root, manifest)
    if stale and stale["file"] != fname:
        try:
            os.remove(os.path.join(root, stale["file"]))
        except OSError:
            pass
    return dest


def list_models(root: Optional[str] = None):
    return sorted(_load_manifest(_root(root)))


def purge(root: Optional[str] = None) -> None:
    """Remove every stored weight file and the manifest."""
    root = _root(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params") or f == _MANIFEST:
            try:
                os.remove(os.path.join(root, f))
            except OSError:
                pass
