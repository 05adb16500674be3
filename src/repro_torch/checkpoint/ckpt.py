"""Fault-tolerant checkpointing: atomic, keep-k, async, the reference's layout.

Port of ``repro.checkpoint.ckpt``, writing and reading the same files:

    <dir>/step_<n>/   (written to step_<n>.tmp then os.replace'd)
        manifest.json   {"step", "extra", "leaves": [{"path", "shape", "dtype"}]}
        leaf_<i>.npy    one array per leaf, bf16 stored as its uint16 words

A tree is flattened as ``jax.tree_util`` flattens the reference's trees:
dict keys sorted (``['k']``), ``Attrs`` nodes (the reference's NamedTuples)
and lists in order (``.name``, ``[i]``), ``None`` dropped; the manifest
keeps each leaf's ``keystr`` path.  A ``Stacked`` leaf (per-layer tensors
the reference stacks on a leading ``n_layers`` axis) is stacked on write
and split on read, so each side restores the other's checkpoints.

``restore`` copies into the tensors of the tree it is given, in place, after
checking paths, shapes and dtypes against the manifest.  ``save`` copies the
leaves to the host before it returns; with ``async_save`` a worker thread
writes the files.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import instrument as obs


class Attrs(dict):
    """A node whose keys are attribute names, flattened in insertion order
    with ``.name`` paths (a NamedTuple of the reference)."""


class Stacked(NamedTuple):
    """One leaf of the reference held as per-layer tensors of equal shape,
    stacked along ``axis`` (1 for the error-feedback residuals, whose leaves
    are ``(n_pods, n_layers, ...)``)."""
    parts: List[torch.Tensor]
    axis: int = 0


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, Attrs):
        items = [(f".{k}", v) for k, v in tree.items()]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [leaf for key, v in items for leaf in flatten(v, prefix + key)]


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure): dict and ``Attrs`` nodes keep
    their keys, lists their order, ``None`` stays ``None`` (as in a JAX
    tree map); anything else is a leaf, ``Stacked`` and tuples included."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, None if v is None else
                           map_tree(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaf_shape(leaf) -> Tuple[int, ...]:
    """The reference's shape of a leaf: a ``Stacked`` one has its parts'
    count at its axis."""
    if isinstance(leaf, Stacked):
        shape = list(leaf.parts[0].shape)
        shape.insert(leaf.axis, len(leaf.parts))
        return tuple(shape)
    return tuple(leaf.shape)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array in storable form (bf16 as uint16 words)."""
    t = torch.stack(leaf.parts, leaf.axis) if isinstance(leaf, Stacked) else leaf
    t = t.detach().to("cpu", copy=True).contiguous()   # never a view of a live tensor
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    t = leaf.parts[0] if isinstance(leaf, Stacked) else leaf
    return str(t.dtype).split(".")[-1]


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        flat = flatten(tree)
        if obs.enabled():
            obs.counter_inc("ckpt/shards", len(flat), op="save")
        # copy to the host before returning: the caller may update in place
        leaves = [(path, _host(leaf), _dtype_name(leaf)) for path, leaf in flat]
        if self.async_save:
            self._pending = self._pool.submit(self._write, step, leaves,
                                              extra or {})
        else:
            self._write(step, leaves, extra or {})

    def _write(self, step: int, leaves, extra: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(os.path.join(final, "manifest.json")):
            obs.counter_inc("ckpt/save_skipped", 1)
            return  # this step is already durably published
        t0 = time.perf_counter()
        nbytes = 0
        with obs.span("ckpt/save", step=step):
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra, "leaves": []}
            for i, (path, arr, dtype_name) in enumerate(leaves):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                nbytes += arr.nbytes
                manifest["leaves"].append(
                    {"path": path, "shape": list(arr.shape), "dtype": dtype_name})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final)              # atomic publish
            self._gc()
        obs.hist_observe("ckpt/save_ms", (time.perf_counter() - t0) * 1e3)
        obs.counter_inc("ckpt/saves", 1)
        obs.counter_inc("ckpt/bytes_written", nbytes)
        obs.counter_inc("ckpt/leaves", len(leaves), op="save")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish a pending write and stop the writer thread."""
        self.wait()
        self._pool.shutdown()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, like: Any,
                blocks: Optional[Dict[str, Tuple[tuple, Callable]]] = None
                ) -> Tuple[Any, dict]:
        """Copy checkpoint ``step`` into the tensors of ``like``, in place.

        Every leaf of ``like`` must be in the manifest under its path, with
        the same shape and dtype, and the manifest may hold no other leaf.
        ``blocks`` maps a leaf path to ``(whole shape, cut)`` where ``like``
        holds a block of the checkpoint's leaf (a rank's share on a mesh):
        the manifest must hold the whole shape, each whole part (a
        ``Stacked`` leaf's, or the leaf) is read on the host and only
        ``cut(part)`` is copied in.  Returns ``(like, extra dict)``.
        """
        t0 = time.perf_counter()
        nbytes = 0
        with obs.span("ckpt/restore", step=step):
            d = os.path.join(self.directory, f"step_{step:08d}")
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            index = {m["path"]: i for i, m in enumerate(manifest["leaves"])}
            flat = flatten(like)
            if len(flat) != len(index) or any(p not in index for p, _ in flat):
                raise ValueError(
                    f"checkpoint {d} holds leaves {sorted(index)}, expected "
                    f"{[p for p, _ in flat]}")
            for path, leaf in flat:
                want = manifest["leaves"][index[path]]
                shape, cut = (blocks or {}).get(path, (leaf_shape(leaf), None))
                if want["shape"] != list(shape) or \
                        want["dtype"] != _dtype_name(leaf):
                    raise ValueError(
                        f"{path}: checkpoint has {want['dtype']} {want['shape']}, "
                        f"expected {_dtype_name(leaf)} {list(shape)}")
                arr = np.load(os.path.join(d, f"leaf_{index[path]}.npy"))
                nbytes += arr.nbytes
                t = _from_storable(arr, want["dtype"])
                stacked = isinstance(leaf, Stacked)
                for part, src in zip(leaf.parts if stacked else [leaf],
                                     t.unbind(leaf.axis) if stacked else [t]):
                    part.copy_(src if cut is None else cut(src))
        obs.hist_observe("ckpt/restore_ms", (time.perf_counter() - t0) * 1e3)
        obs.counter_inc("ckpt/restores", 1)
        obs.counter_inc("ckpt/bytes_read", nbytes)
        obs.counter_inc("ckpt/leaves", len(flat), op="restore")
        if obs.enabled():
            obs.counter_inc("ckpt/shards", len(flat), op="restore")
        return like, manifest["extra"]
