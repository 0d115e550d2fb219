"""Modules and checkpoints on disk, in the JAX package's npz format.

Counterpart of ``bigdl_tpu/utils/serializer.py``: ``module_to_spec``/
``spec_to_module`` (:88, :119), ``save_module``/``load_module`` (:157,
:190), the checkpoint writer with its sha256 manifest and ``.optim`` →
``.model`` → manifest order (:220-593), and ``save_checkpoint``,
``load_checkpoint`` and ``load_latest_checkpoint`` (:593-668).

A module is a JSON spec (class name, the constructor arguments under
the JAX package's names, children) plus its parameter and state leaves
as ``p{i}``/``s{i}`` in JAX's leaf order (``utils/tree.py``), so each
package reads the other's files: a spec is rebuilt with
``cls(**config)`` from either package's classes of that name.  A spec
this package cannot rebuild raises; nothing is skipped.  The protobuf
``.bigdl`` format, background writes, the observability spans and the
fault-injection hook are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import AbstractModule, Container
from bigdl_tpu_torch.utils import tree as T

log = logging.getLogger("bigdl_tpu_torch.serializer")


class CheckpointIntegrityError(RuntimeError):
    """No intact checkpoint could be found or loaded in a directory."""


_REGISTRY: Dict[str, type] = {}


def _build_registry(rescan: bool = False) -> Dict[str, type]:
    if _REGISTRY and not rescan:
        return _REGISTRY
    import bigdl_tpu_torch.models  # noqa: F401  (registers model modules)
    import bigdl_tpu_torch.nn  # noqa: F401

    def scan(cls):
        _REGISTRY.setdefault(cls.__name__, cls)
        for sub in cls.__subclasses__():
            scan(sub)

    scan(AbstractModule)
    return _REGISTRY


def lookup_module_class(name: str) -> type:
    """The port's layer class of that name (a user's ``AbstractModule``
    subclass too, once it is defined)."""
    reg = _build_registry()
    if name not in reg:
        reg = _build_registry(rescan=True)
    if name not in reg:
        raise KeyError(f"unknown module class {name!r}")
    return reg[name]


def module_to_spec(module: AbstractModule) -> dict:
    spec = {"class": type(module).__name__, "config": module.get_config()}
    name = getattr(module, "_name", None)
    if name:
        spec["name"] = name
    if isinstance(module, Container):
        spec["children"] = [module_to_spec(m) for m in module.modules]
    return spec


def spec_to_module(spec: dict) -> AbstractModule:
    if "graph" in spec:
        raise NotImplementedError(
            "Graph modules are not ported yet (ROADMAP.md queue 1 item 12)")
    cls = lookup_module_class(spec["class"])
    module = cls(**spec.get("config", {}))
    if "children" in spec:
        if not isinstance(module, Container):
            raise TypeError(f"{spec['class']} is not a container but its "
                            "spec has children")
        # rebuilt structurally: a container's own add() may wrap a child
        module._modules.clear()
        for i, child in enumerate(spec["children"]):
            module.add_module(str(i), spec_to_module(child))
    if "name" in spec:
        module.set_name(spec["name"])
    return module


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _module_arrays(spec, p_leaves, s_leaves) -> dict:
    """The npz contents ``load_module`` reads: ``p{i}``, ``s{i}`` and
    the JSON spec as bytes."""
    arrays = {f"p{i}": _host(x) for i, x in enumerate(p_leaves)}
    arrays.update({f"s{i}": _host(x) for i, x in enumerate(s_leaves)})
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode("utf-8"),
                                       dtype=np.uint8)
    return arrays


def save_module(module: AbstractModule, path: str) -> str:
    """The module as ``path`` (``.npz`` added); ``.bigdl`` (the
    protobuf interchange format) is not ported yet and raises."""
    if path.endswith(".bigdl"):
        raise NotImplementedError(
            "the .bigdl protobuf format is not ported yet (ROADMAP.md "
            "queue 1 item 8)")
    arrays = _module_arrays(module_to_spec(module),
                            T.leaves(module.params()),
                            T.leaves(module.state()))
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **arrays)
    return path


def _set_leaves(tree, values):
    """The tree with its leaves, in JAX order, replaced by ``values``."""
    pairs = T.leaves_with_paths(tree)
    if len(pairs) != len(values):
        raise ValueError(f"file holds {len(values)} leaves, the module "
                         f"{len(pairs)}")
    return T.unflatten([(p, v) for (p, _), v in zip(pairs, values)])


def load_module(path: str) -> AbstractModule:
    """A module from ``save_module``'s (or the JAX package's) npz, on
    the CPU."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":
        raise NotImplementedError(
            f"{path} is not an npz container; the .bigdl protobuf format "
            "is not ported yet (ROADMAP.md queue 1 item 8)")
    with np.load(path) as data:
        spec = json.loads(bytes(data["__spec__"]).decode("utf-8"))
        module = spec_to_module(spec)
        n_p = len(T.leaves(module.params()))
        n_s = len(T.leaves(module.state()))
        p = [torch.from_numpy(np.array(data[f"p{i}"])) for i in range(n_p)]
        s = [torch.from_numpy(np.array(data[f"s{i}"])) for i in range(n_s)]
    if p:
        module.set_params(_set_leaves(module.params(), p))
    if s:
        module.set_state(_set_leaves(module.state(), s))
    return module


# ---- checkpoints ------------------------------------------------------------
def snapshot_checkpoint(model, optim_method=None, extra: dict = None) -> dict:
    """Everything a checkpoint holds, copied to host numpy now (the
    port writes synchronously)."""
    snap = {"spec": module_to_spec(model),
            "p_leaves": [_host(v) for v in T.leaves(model.params())],
            "s_leaves": [_host(v) for v in T.leaves(model.state())],
            "optim": None}
    if optim_method is not None:
        snap["optim"] = {"class": type(optim_method).__name__,
                         "arrays": optim_method.get_state_arrays(),
                         "extra": extra or {}}
    return snap


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_savez(path: str, arrays: dict) -> str:
    """``np.savez`` to a temporary file, fsync, rename, fsync the
    directory: a reader never sees a torn file."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return path


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_CKPT_SUFFIXES = (".model.npz", ".optim.npz")


def write_manifest(path_prefix: str, topology: dict = None) -> str:
    """Size and sha256 of each file of the pair, and the writer's
    ``topology``, written atomically after the pair."""
    files = {}
    for suffix in _CKPT_SUFFIXES:
        p = path_prefix + suffix
        if os.path.exists(p):
            files[os.path.basename(p)] = {"size": os.path.getsize(p),
                                          "sha256": _sha256(p)}
    manifest_path = path_prefix + ".manifest.json"
    doc = {"format": 1, "files": files}
    if topology:
        doc["topology"] = topology
    tmp = manifest_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, manifest_path)
    _fsync_dir(os.path.dirname(manifest_path))
    return manifest_path


def read_checkpoint_topology(path_prefix: str) -> dict:
    """The writer's topology, from the manifest, else from the
    ``.optim`` meta; ``{}`` when neither has one."""
    try:
        with open(path_prefix + ".manifest.json", "r",
                  encoding="utf-8") as fh:
            topo = json.load(fh).get("topology")
            if topo:
                return topo
    except (OSError, ValueError):
        pass
    try:
        with np.load(path_prefix + ".optim.npz") as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        return (meta.get("extra") or {}).get("topology") or {}
    except Exception:  # noqa: BLE001 - an absent or torn pair has none
        return {}


def verify_checkpoint(path_prefix: str):
    """``(ok, reason)`` for one checkpoint pair.  With a manifest every
    recorded file must exist with its size and sha256; without one the
    model npz must open, and a leftover temporary file of the prefix
    marks an interrupted write."""
    model_path = path_prefix + ".model.npz"
    if not os.path.exists(model_path):
        return False, "missing .model.npz"
    manifest_path = path_prefix + ".manifest.json"
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, "r", encoding="utf-8") as fh:
                files = json.load(fh)["files"]
        except Exception as e:  # noqa: BLE001 - any unreadable manifest
            return False, f"unreadable manifest: {e}"
        directory = os.path.dirname(path_prefix)
        for name, rec in files.items():
            p = os.path.join(directory, name)
            if not os.path.exists(p):
                return False, f"missing {name}"
            if os.path.getsize(p) != rec["size"]:
                return False, (f"{name}: size {os.path.getsize(p)} != "
                               f"recorded {rec['size']}")
            if _sha256(p) != rec["sha256"]:
                return False, f"{name}: checksum mismatch"
        return True, "ok"
    for leftover in (path_prefix + ".model.npz.tmp.npz",
                     path_prefix + ".optim.npz.tmp.npz",
                     manifest_path + ".tmp"):
        if os.path.exists(leftover):
            return False, (f"no manifest + leftover "
                           f"{os.path.basename(leftover)}: interrupted "
                           "checkpoint write")
    try:
        with np.load(model_path) as data:
            data.files
    except Exception as e:  # noqa: BLE001 - any unreadable container
        return False, f"unreadable .model.npz: {e}"
    return True, "ok (no manifest)"


def checkpoint_prefixes(directory: str):
    """Checkpoint prefixes in ``directory``, oldest first by the model
    file's mtime."""
    cands = [f[:-len(".model.npz")] for f in os.listdir(directory)
             if f.endswith(".model.npz")]
    cands.sort(key=lambda f: os.path.getmtime(
        os.path.join(directory, f + ".model.npz")))
    return cands


def gc_checkpoints(directory: str, keep_last: int):
    """Delete every checkpoint pair older than the newest ``keep_last``
    (``<= 0`` keeps all); returns the removed file names."""
    if keep_last <= 0:
        return []
    doomed = checkpoint_prefixes(directory)[:-keep_last]
    removed = []
    for prefix in doomed:
        for f in os.listdir(directory):
            if f in (prefix + ".manifest.json",
                     prefix + ".manifest.json.tmp") or (
                    f.startswith(prefix + ".") and ".npz" in f):
                try:
                    os.remove(os.path.join(directory, f))
                    removed.append(f)
                except OSError:
                    pass
    if removed:
        log.info("checkpoint GC: removed %d files of %d old prefixes "
                 "(keep_last=%d)", len(removed), len(doomed), keep_last)
    return removed


def write_checkpoint(snap: dict, path_prefix: str, keep_last: int = 0):
    """Write a ``snapshot_checkpoint``: ``.optim`` first, then
    ``.model`` (checkpoint discovery keys on it), then the manifest,
    each atomic; then the retention."""
    if snap["optim"] is not None:
        opt_arrays = dict(snap["optim"]["arrays"])
        meta = {"class": snap["optim"]["class"],
                "extra": snap["optim"]["extra"]}
        opt_arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
        _atomic_savez(path_prefix + ".optim", opt_arrays)
    _atomic_savez(path_prefix + ".model",
                  _module_arrays(snap["spec"], snap["p_leaves"],
                                 snap["s_leaves"]))
    extra = (snap["optim"] or {}).get("extra") or {}
    write_manifest(path_prefix, topology=extra.get("topology"))
    if keep_last:
        gc_checkpoints(os.path.dirname(path_prefix) or ".", keep_last)
    return path_prefix


def save_checkpoint(path_prefix: str, model, optim_method=None,
                    extra: dict = None, keep_last: int = 0):
    """Model, optimizer state and ``extra`` (epoch, neval, topology)
    as one checkpoint pair with its manifest."""
    return write_checkpoint(snapshot_checkpoint(model, optim_method, extra),
                            path_prefix, keep_last=keep_last)


def load_checkpoint(path_prefix: str, model, optim_method=None) -> dict:
    """Load the weights into ``model`` (in place, on its device) and
    the state into ``optim_method``; returns the ``extra`` dict."""
    loaded = load_module(path_prefix + ".model")
    model.set_params(loaded.params())
    model.set_state(loaded.state())
    extra = {}
    optim_path = path_prefix + ".optim.npz"
    if optim_method is not None and os.path.exists(optim_path):
        with np.load(optim_path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            arrays = {k: np.array(data[k]) for k in data.files
                      if k != "__meta__"}
        extra = meta.get("extra", {})
        optim_method.load_state_arrays(arrays)
        # a trainer checks the writer's layout against its own
        optim_method.loaded_topology = extra.get("topology")
    return extra


def load_latest_checkpoint(directory: str, model, optim_method=None,
                           verify: bool = True) -> dict:
    """Load the newest intact checkpoint in ``directory``: candidates
    newest first, one that fails ``verify_checkpoint`` or its load is
    skipped with a warning.  Raises ``CheckpointIntegrityError`` when
    none survives."""
    cands = checkpoint_prefixes(directory)
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    failures = []
    for name in reversed(cands):
        prefix = os.path.join(directory, name)
        if verify:
            ok, reason = verify_checkpoint(prefix)
            if not ok:
                log.warning("skipping checkpoint %s: %s", name, reason)
                failures.append(f"{name}: {reason}")
                continue
        try:
            return load_checkpoint(prefix, model, optim_method)
        except Exception as e:  # noqa: BLE001 - fall back to an older pair
            if not verify:
                raise
            log.warning("failed loading checkpoint %s: %s", name, e)
            failures.append(f"{name}: load failed: {e}")
    raise CheckpointIntegrityError(
        f"no intact checkpoint in {directory}: " + "; ".join(failures))


__all__ = ["CheckpointIntegrityError", "lookup_module_class", "module_to_spec", "spec_to_module",
           "save_module", "load_module", "snapshot_checkpoint",
           "write_manifest", "read_checkpoint_topology", "verify_checkpoint",
           "checkpoint_prefixes", "gc_checkpoints", "write_checkpoint",
           "save_checkpoint", "load_checkpoint", "load_latest_checkpoint"]
