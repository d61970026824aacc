"""Checkpoints in the reference's format: npz + manifest, atomic, async.

Port of `repro.checkpoint.ckpt`; each package reads the other's files.

  * layout: <dir>/step_<N>/shard_0.npz + manifest.json.  Keys are the
    reference's `jax.tree_util.keystr` strings: a dict entry `['params']`,
    a list or tuple index `[0]`, a NamedTuple field `.mu` (so a Trainer
    state reads `['params']['blocks']...`, `['opt'].step`, `['opt'].mu[...]`)
  * atomicity: written to step_<N>.tmp/, then renamed to step_<N>; a crashed
    writer never leaves a half checkpoint where `latest_step` looks
  * integrity: the manifest records each array's shape, dtype and crc32 (of
    the bytes stored); restore checks them before handing anything back
  * bfloat16: npz cannot hold it, so its raw bits are stored as uint16 and
    the manifest says "bfloat16" (torch's own bits, no `ml_dtypes`)
  * async: `CheckpointManager.save_async` copies every leaf to the host,
    then a writer thread serializes while the next step runs

Leaves are tensors (or numpy arrays) on any device; they restore onto the
device of the `tree_like` leaf they replace, in its dtype, or, given
`shardings`, as DTensors on a `DeviceMesh` (the elastic restore).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import zipfile
import zlib
from typing import Any

import numpy as np
import torch


_STEP = re.compile(r"step_(\d+)")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key string, child) for a dict, NamedTuple, list or tuple node, as
    `jax.tree_util.keystr` writes each key; None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree: Any, path: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {path: tree}
    out: dict[str, Any] = {}
    for key, child in kids:
        out.update(_flatten(child, path + key))
    return out


def _unflatten(like: Any, leaves: dict[str, Any], path: str = "") -> Any:
    """A tree shaped as `like` (its dicts in their own key order) whose leaf
    at each path is `leaves[path]`."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{path}[{k!r}]") for k, v in like.items()}
    kids = _children(like)
    if kids is None:
        return leaves[path]
    vals = [_unflatten(child, leaves, path + key) for key, child in kids]
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _to_host(leaf: Any) -> np.ndarray:
    """A copy of `leaf` in host memory, savable by npz: a bfloat16 tensor as
    its uint16 bits (the reference's `_to_savable`)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    return np.array(leaf)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _write(dirpath, step: int, host: dict[str, np.ndarray], dtypes: dict[str, str],
           host_id: int) -> pathlib.Path:
    d = pathlib.Path(dirpath)
    tmp, final = d / f"step_{step}.tmp", d / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"shard_{host_id}.npz", **host)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k], "crc32": _crc(v)}
                   for k, v in host.items()},
        "hosts": 1,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish
    return final


def _snapshot(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat = _flatten(tree)
    return ({k: _to_host(v) for k, v in flat.items()},
            {k: _dtype_name(v) for k, v in flat.items()})


def save_checkpoint(dirpath: str | pathlib.Path, step: int, tree: Any,
                    *, host_id: int = 0) -> pathlib.Path:
    """Write `tree` as step `step` under `dirpath`; returns the step's directory."""
    host, dtypes = _snapshot(tree)
    return _write(dirpath, step, host, dtypes, host_id)


def latest_step(dirpath: str | pathlib.Path) -> int | None:
    d = pathlib.Path(dirpath)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir() if (m := _STEP.fullmatch(p.name))]
    return max(steps) if steps else None


def _from_saved(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != dtype_name:
        raise IOError(f"checkpoint array stored as {a.dtype}, manifest says {dtype_name}")
    return torch.from_numpy(a)


def _shardings_by_leaf(shardings: Any, like: Any, path: str = "") -> dict[str, Any]:
    """Leaf path -> sharding, `shardings` walked beside `like`: a None node
    leaves everything under it unsharded (a tree prefix, as JAX's
    shardings are); any other node must have `like`'s structure."""
    if shardings is None:
        return {}
    kids, like_kids = _children(shardings), _children(like)
    if kids is None:
        if like_kids is not None:
            raise ValueError(f"shardings: one sharding at {path or 'the root'}, a subtree "
                             "in tree_like")
        return {path: shardings}
    if like_kids is None or [k for k, _ in kids] != [k for k, _ in like_kids]:
        raise ValueError(f"shardings: the tree at {path or 'the root'} is not tree_like's")
    out: dict[str, Any] = {}
    for key, child in kids:
        out.update(_shardings_by_leaf(child, dict(like_kids)[key], path + key))
    return out


def restore_checkpoint(dirpath: str | pathlib.Path, tree_like: Any,
                       step: int | None = None, *, shardings: Any = None) -> Any:
    """Restore step `step` (default: the latest) into the structure of
    `tree_like`, each leaf cast to its `tree_like` leaf's dtype and placed on
    that leaf's device.  Raises IOError where an array's crc32, or the
    npz's own, disagrees.

    `shardings` (a tree shaped as `tree_like` whose leaves are
    `distributed.sharding.NamedSharding`s, None standing for a whole
    unsharded subtree) re-shards onto the current mesh: a leaf with a
    sharding comes back as a DTensor laid out by it (`distribute_tensor`
    on its `DeviceMesh`, every rank having read the same file), the others
    as above.  That is the elastic-scaling path: a checkpoint saved on
    mesh A restores on any mesh B."""
    d = pathlib.Path(dirpath)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {d}")
    cdir = d / f"step_{step}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    arrays: dict[str, np.ndarray] = {}
    for shard in sorted(cdir.glob("shard_*.npz")):
        try:
            with np.load(shard) as z:
                for k in z.files:
                    arrays[k] = z[k]
        except zipfile.BadZipFile as e:
            raise IOError(f"checkpoint corruption in {shard.name} at step {step}: {e}") from e
    tensors = {}
    for k, meta in manifest["arrays"].items():
        if _crc(arrays[k]) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {k} at step {step}")
        tensors[k] = _from_saved(arrays[k], meta["dtype"])
    flat_like = _flatten(tree_like)
    flat_sh = _shardings_by_leaf(shardings, tree_like)
    out = {}
    for k, like in flat_like.items():
        sh = flat_sh.get(k)
        if sh is None:
            out[k] = tensors[k].to(like.device, like.dtype)
        else:
            from torch.distributed.tensor import distribute_tensor
            out[k] = distribute_tensor(tensors[k].to(sh.mesh.device_type, like.dtype),
                                       sh.mesh, sh.placements())
    return _unflatten(tree_like, out)


class CheckpointManager:
    """Async checkpointing + retention (the newest `keep` steps) + auto-resume."""

    def __init__(self, dirpath: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(dirpath)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree: Any) -> None:
        """Copy every leaf to the host now (a consistent snapshot: later
        in-place updates of the tree do not reach it), then write on a
        background thread.  A previous write is waited for first."""
        host, dtypes = _snapshot(tree)
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(step, host, dtypes),
                                        daemon=True)
        self._thread.start()

    def _run(self, step, host, dtypes) -> None:
        try:
            _write(self.dir, step, host, dtypes, 0)
            self._gc()
        except Exception as e:              # re-raised on the caller's thread by wait()
            self._error = e

    def wait(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for p in self.dir.iterdir()
                       if (m := _STEP.fullmatch(p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, tree_like: Any, shardings: Any = None) -> tuple[Any, int] | None:
        step = latest_step(self.dir)
        if step is None:
            return None
        return restore_checkpoint(self.dir, tree_like, step, shardings=shardings), step
