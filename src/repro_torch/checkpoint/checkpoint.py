"""Tree checkpoints without extra dependencies: one ``.npz`` of leaves plus
a JSON manifest (the port of ``repro.checkpoint.checkpoint``).

The format is the reference's, so a run saved by either package resumes
in the other:

* leaves are flattened in ``jax.tree_util`` order (dict keys sorted,
  tuples and NamedTuples by position; ``()`` adds no leaf) and stored as
  ``leaf_<i>``; the manifest keeps ``n_leaves``, the leaves' dtype names
  and the caller's ``meta``;
* a Python ``int`` (the port's round counter) is written as an int32
  leaf, as the reference's round is;
* key data (``prng.key_data``: int64, last axis 2 words) is written as
  the reference's uint32 words; any other int64 leaf is refused rather
  than guessed at;
* bfloat16 leaves are stored as npz's opaque 2-byte void type under the
  manifest name ``bfloat16``, as the reference stores them, and are read
  back through their bits, without ``ml_dtypes`` (a numpy template gets
  the uint16 bits, as ``convert.to_host`` gives them).

``save`` writes atomically (a temporary file, then ``os.replace``).
``load(like=)`` rebuilds ``like``'s structure, giving each leaf the kind
of ``like``'s: an ``int`` stays an ``int``, a key comes back through
``prng.key_data`` (int64), a tensor lands on ``like``'s device, a numpy
array stays numpy.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.convert import to_host

PyTree = Any

_BF16 = "bfloat16"


class CheckpointStructureError(ValueError):
    """``load(like=)``'s template does not match the stored leaf count."""


class CheckpointDtypeError(ValueError):
    """An extension-dtype leaf without a dtype name the port can read."""


def _check_key(t: torch.Tensor) -> None:
    """int64 leaves cross as key data only: the port's keys are int64
    ``(..., 2)`` words, and nothing else of its state is int64."""
    if t.shape[-1:] != (2,):
        raise TypeError(
            f"int64 leaf of shape {tuple(t.shape)} is not key data (..., 2); "
            "checkpoints carry int64 only as PRNG keys")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """One leaf as the array ``np.savez`` stores, and its dtype name."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if isinstance(leaf, torch.Tensor):
        a = to_host(leaf)
        if leaf.dtype == torch.bfloat16:
            return a.view(np.dtype("V2")), _BF16
        if leaf.dtype == torch.int64:
            _check_key(leaf)
            if a.size and (int(a.min()) < 0 or int(a.max()) > prng.MASK32):
                raise ValueError("key data must hold uint32 words")
            return a.astype(np.uint32), "uint32"
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str | Path, tree: PyTree, meta: Optional[dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(tree_util.leaves(tree)):
        arrays[f"leaf_{i}"], name = _to_numpy(leaf)
        dtypes.append(name)
    manifest = {
        # the reference writes its treedef here and neither loader reads
        # it back: load(like=) takes the structure from the template
        "treedef": f"repro_torch leaves of {type(tree).__name__}",
        "meta": meta or {},
        "n_leaves": len(arrays),
        "dtypes": dtypes,
    }
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __manifest__=json.dumps(manifest), **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   path)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)


def _tensor(raw: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name == _BF16:
        return torch.from_numpy(raw.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(raw, copy=True))


def _like_leaf(raw: np.ndarray, name: Optional[str], like):
    """A stored leaf in the kind of the template's leaf."""
    if isinstance(like, int):
        return int(raw)
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.int64:
            _check_key(like)
            return prng.key_data(np.asarray(raw)).to(like.device)
        return _tensor(raw, name).to(like.device)
    if isinstance(like, np.ndarray):
        return raw.view(np.uint16) if name == _BF16 else np.array(raw)
    return _tensor(raw, name)


def _rebuild(like: PyTree, values) -> PyTree:
    """``like``'s structure over ``values`` in leaf order (NamedTuples keep
    their type)."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, tuple):
        children = [_rebuild(c, values) for c in like]
        return (type(like)(*children) if hasattr(like, "_fields")
                else tuple(children))
    return next(values)


def load(path: str | Path, like: Optional[PyTree] = None
         ) -> Tuple[PyTree, dict]:
    """Load a checkpoint written by either package: ``(tree, meta)`` with
    ``like``'s structure, or ``(list of tensors, meta)`` without it.

    Raises :class:`CheckpointStructureError` when ``like`` does not have
    the stored number of leaves, and :class:`CheckpointDtypeError` for an
    extension-dtype leaf whose manifest has no dtype names, or whose dtype
    is not bfloat16."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        dtypes = manifest.get("dtypes")          # absent in old checkpoints
        raws: List[Tuple[np.ndarray, Optional[str]]] = []
        for i in range(manifest["n_leaves"]):
            raw = z[f"leaf_{i}"]
            name = dtypes[i] if dtypes is not None else None
            if raw.dtype.kind == "V":
                if dtypes is None:
                    raise CheckpointDtypeError(
                        f"checkpoint {path} leaf_{i} has extension-dtype "
                        f"data ({raw.dtype}) but its manifest predates the "
                        "'dtypes' field; re-save it with a current writer")
                if name != _BF16:
                    raise CheckpointDtypeError(
                        f"checkpoint {path} leaf_{i} is {name}; the port "
                        "reads bfloat16 as its only extension dtype")
            raws.append((raw, name))
    if like is None:
        return [_tensor(raw, name) for raw, name in raws], manifest["meta"]
    like_leaves = tree_util.leaves(like)
    if len(like_leaves) != len(raws):
        raise CheckpointStructureError(
            f"checkpoint {path} stores {len(raws)} leaves but like= has "
            f"{len(like_leaves)}; the template does not match what was "
            "saved (wrong algorithm or config, e.g. a state built under a "
            "different downlink or store mode)")
    values = iter([_like_leaf(raw, name, ll)
                   for (raw, name), ll in zip(raws, like_leaves)])
    return _rebuild(like, values), manifest["meta"]
