"""Checkpoint and resume of the port's inference state.

The port's counterpart of pclean_tpu/engine/checkpoint.py (save_checkpoint,
load_checkpoint) and of pclean_tpu/engine/aot.py's `fingerprint`. The
state is nested dicts of tensors (arenas, params) and the torch.Generator
the drivers draw from, saved by its get_state() where JAX saves its key:
K22 and K23 draw their Philox seed from that generator (ops.draw_seed),
so its state covers them too. Callers put Engine.log_ml in `meta`; a
tensor anywhere in `meta` is saved as an array like the state's leaves.

The format is a dependency-free .npz written atomically: each tensor a
numpy array, beside a pickled payload holding the format version, the
compiled model's fingerprint, the tree's skeleton (its dicts, lists and
tuples with each tensor replaced by its leaf index) and the generator's
device. A checkpoint loads onto the caller's device.
"""
from __future__ import annotations

import glob
import hashlib
import io
import os
import pickle
import re
from typing import Any, Optional

import numpy as np
import torch

from ..utils import resolve_device

FORMAT_VERSION = 1
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_src_hash_cache: Optional[str] = None


def _source_hash() -> str:
    """The port's own sources (every .py, and the kernels' .cu/.cuh), so a
    checkpoint is refused after a code change."""
    global _src_hash_cache
    if _src_hash_cache is None:
        h = hashlib.sha256()
        paths = [p for pat in ("**/*.py", "csrc/*.cu", "csrc/*.cuh")
                 for p in glob.glob(os.path.join(_PKG_DIR, pat),
                                    recursive=True)]
        for path in sorted(paths):
            with open(path, "rb") as f:
                h.update(f.read())
        _src_hash_cache = h.hexdigest()[:16]
    return _src_hash_cache


def _stable_repr(o, depth: int = 0) -> str:
    """A repr that is the same in every process (pclean_tpu/engine/aot.py's
    _stable_repr): functions hash by code object and closure contents, not
    by their address."""
    if depth > 12:
        return "..."
    if callable(o) and hasattr(o, "__code__"):
        code = o.__code__
        h = hashlib.sha256(code.co_code)
        for c in code.co_consts:
            if isinstance(c, (str, bytes, int, float, bool, type(None))):
                h.update(repr(c).encode())
        if o.__closure__:
            for cell in o.__closure__:
                try:
                    h.update(_stable_repr(cell.cell_contents,
                                          depth + 1).encode("utf-8", "ignore"))
                except ValueError:
                    h.update(b"<empty-cell>")
        return (f"fn:{os.path.basename(code.co_filename)}:"
                f"{code.co_firstlineno}:{h.hexdigest()[:12]}")
    if isinstance(o, dict):
        try:
            items = sorted(o.items())
        except TypeError:
            items = list(o.items())
        return "{" + ",".join(f"{_stable_repr(k, depth + 1)}:"
                              f"{_stable_repr(v, depth + 1)}"
                              for k, v in items) + "}"
    if isinstance(o, (list, tuple, set, frozenset)):
        body = ",".join(_stable_repr(x, depth + 1) for x in o)
        return f"{type(o).__name__}({body})"
    if isinstance(o, np.ndarray):
        return f"nd{o.shape}{o.dtype}:" + hashlib.sha256(
            np.ascontiguousarray(o).tobytes()).hexdigest()[:12]
    if isinstance(o, (str, bytes, int, float, bool, type(None))):
        return repr(o)
    d = getattr(o, "__dict__", None)
    if d is not None:
        return f"{type(o).__name__}({_stable_repr(d, depth + 1)})"
    return re.sub(r"0x[0-9a-f]+", "0x~", repr(o))


def fingerprint(cm) -> str:
    """The compiled model's fingerprint (pclean_tpu/engine/aot.py's, over
    the port's structures and sources): the port's sources, every class's
    nodes, blocks and hash keys, the compute tables, the list registries,
    the domains' vocabularies, the observation arrays and the capacities.
    Everything hashed is the same in every process."""
    h = hashlib.sha256()
    h.update(_source_hash().encode())
    for cid in cm.model.class_order:
        c = cm.cls(cid)
        h.update(cid.encode())
        for n in c.nodes:
            h.update(type(n).__name__.encode())
            h.update(_stable_repr(
                sorted(vars(n).items())).encode("utf-8", "ignore"))
        h.update(repr(c.blocks).encode())
        h.update(repr(c.hash_keys).encode())
    for key in sorted(cm.tables):
        h.update(repr(key).encode())
        h.update(np.ascontiguousarray(cm.tables[key]).tobytes())
    for key in sorted(cm.list_reg):
        h.update(repr(key).encode())
        h.update(repr(cm.list_reg[key]._lists).encode())
    for (cid, vid), dom in sorted(cm.domains.items()):
        h.update(f"{cid}:{vid}".encode())
        if dom is not None and dom.vocab is not None:
            h.update(repr(dom.vocab.values)[:100000].encode("utf-8", "ignore"))
    for spec in cm.obs_specs:
        for vid in sorted(spec.columns):
            codes, state = spec.columns[vid]
            h.update(np.ascontiguousarray(codes).tobytes())
            h.update(np.ascontiguousarray(state).tobytes())
    for cid, lay in sorted(cm.layouts.items()):
        h.update(f"{cid}:{lay.capacity}".encode())
    return h.hexdigest()[:24]


def _flatten(tree, leaves: list):
    """The tree's skeleton, each tensor replaced by ("leaf", index) and
    appended to `leaves` as a numpy array."""
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if torch.is_tensor(tree):
        leaves.append(tree.detach().cpu().numpy())
        return _Leaf(len(leaves) - 1)
    return tree


def _unflatten(skel, leaves: list, device):
    if isinstance(skel, _Leaf):
        return torch.as_tensor(leaves[skel.index]).to(device)
    if isinstance(skel, dict):
        return {k: _unflatten(v, leaves, device) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_unflatten(v, leaves, device) for v in skel)
    return skel


class _Leaf:
    """A tensor's place in a checkpoint's skeleton."""

    def __init__(self, index: int):
        self.index = index


def save_checkpoint(path: str, cm, arenas: dict, params: dict,
                    gen: torch.Generator, meta: Optional[dict] = None) -> None:
    """Atomically write the state (arenas, params, the generator's state
    and `meta`, Engine.log_ml among it), with the compiled model's
    fingerprint so that resuming into a different model is refused."""
    leaves: list = []
    skel = _flatten((arenas, params, meta or {}), leaves)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    payload = {
        "version": FORMAT_VERSION,
        "fingerprint": fingerprint(cm),
        "skeleton": skel,
        "gen_device": gen.device.type,
    }
    buf = io.BytesIO()
    np.savez_compressed(
        buf, __payload__=np.frombuffer(pickle.dumps(payload), dtype=np.uint8),
        __gen_state__=gen.get_state().numpy(), **arrays)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str, cm, strict: bool = True,
                    device: Any = None):
    """(arenas, params, generator, meta) from a checkpoint that this
    package wrote, every tensor on `device` (the model's device unless the
    caller names another) and the generator a new one there in the saved
    state (a generator's state belongs to its device type: one saved on the
    card loads onto a card). Raises where the fingerprint differs from the
    compiled model's unless strict=False."""
    dev = cm.device if device is None else resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        payload = pickle.loads(z["__payload__"].tobytes())
        if payload["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version "
                             f"{payload['version']}")
        if strict and payload["fingerprint"] != fingerprint(cm):
            raise ValueError(
                "checkpoint fingerprint does not match the compiled model "
                "(different model structure, dataset or code); pass "
                "strict=False to force")
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        gen_state = torch.as_tensor(z["__gen_state__"])
    if payload["gen_device"] != dev.type:
        raise ValueError(f"the checkpoint's generator was saved on "
                         f"{payload['gen_device']}: load it onto that device")
    arenas, params, meta = _unflatten(payload["skeleton"], leaves, dev)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    return arenas, params, gen, meta
