"""Directory checkpoints of Sampler state: a path ending in ``.orbax``.

The default snapshot format is an atomically written pickle
(``Sampler.save_state``). A path with the ``.orbax`` suffix, or an
existing directory holding ``meta``, selects this directory format
instead, the layout the JAX package's orbax checkpoints have: ``arrays/``
and ``meta``. Here every array is a ``.npy`` file under ``arrays/`` and
``meta`` is one JSON file, the state's structure with a marker where an
array was (the split of ``pocomc_tpu/utils/checkpoint.py``). orbax itself
depends on JAX, which the port does not import, so these directories are
not the JAX package's: neither package reads the other's. Python's json
keeps arbitrary-precision ints, so the 128-bit PCG64 state round-trips
exactly.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

_ARRAY_MARK = "__pocomc_array__"


def _split(node, arrays):
    """The JSON skeleton of ``node``; array leaves go to the list
    ``arrays`` and are replaced by a marker holding their index."""
    if isinstance(node, dict):
        return {str(k): _split(v, arrays) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        out = [_split(v, arrays) for v in node]
        return {"__tuple__": out} if isinstance(node, tuple) else out
    if isinstance(node, np.ndarray):
        arrays.append(node)
        return {_ARRAY_MARK: len(arrays) - 1}
    if isinstance(node, np.integer):
        return int(node)
    if isinstance(node, np.floating):
        return float(node)
    if isinstance(node, np.bool_):
        return bool(node)
    return node  # str / int / float / bool / None


def _join(node, arrays):
    if isinstance(node, dict):
        if _ARRAY_MARK in node:
            return arrays[node[_ARRAY_MARK]]
        if "__tuple__" in node:
            return tuple(_join(v, arrays) for v in node["__tuple__"])
        return {k: _join(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_join(v, arrays) for v in node]
    return node


def save_dir(state: dict, path) -> None:
    """Write ``state`` (nested dicts, lists, tuples, numpy arrays and
    scalars) as a directory: written beside ``path`` under a temporary
    name, then renamed over it."""
    path = Path(path).absolute()
    arrays = []
    meta = _split(state, arrays)
    tmp = path.with_name(f"{path.name}.temp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "arrays").mkdir(parents=True)
    for i, a in enumerate(arrays):
        np.save(tmp / "arrays" / f"{i}.npy", a, allow_pickle=a.dtype.hasobject)
    with open(tmp / "meta", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_dir(path) -> dict:
    path = Path(path)
    with open(path / "meta") as f:
        meta = json.load(f)
    n = len(list((path / "arrays").glob("*.npy")))
    # object arrays (string blobs) are pickled inside their .npy file
    arrays = [np.load(path / "arrays" / f"{i}.npy", allow_pickle=True) for i in range(n)]
    return _join(meta, arrays)


def is_dir_path(path) -> bool:
    """Path convention: the ``.orbax`` suffix or an existing directory
    checkpoint."""
    p = Path(path)
    return p.suffix == ".orbax" or (p.is_dir() and (p / "meta").exists())
