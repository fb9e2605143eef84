"""Fault-tolerant checkpointing: atomic, async-capable, topology-free (the
reference's ``repro/train/checkpoint.py`` layout and guarantees).

Layout:  <dir>/step_<k>/arr_<i>.npy + tree.json ; <dir>/LATEST (text).

* **atomic publish**: the step directory is written under
  ``step_<k>.tmp`` and ``os.replace``-d; LATEST is written through a tmp
  file and a replace too, so a crash at any instant leaves the previous
  checkpoint whole, and ``latest_step`` ignores ``.tmp`` directories;
* **topology independence**: arrays are saved whole, as numpy, and put
  on whatever device the restore names.  A sharded ``TrainState``
  (``train_step.shard_state``) is saved by every rank together: the shards
  are gathered whole (``train_step.full_tensors``) and rank 0 writes them
  in the same format; a restore into a sharded state slices the whole
  arrays for its own mesh, and ``restore(..., mesh=)`` shards a whole state
  after filling it, so a checkpoint moves between meshes, and between a
  mesh and one device, both ways;
* **async**: ``save(..., asynchronous=True)`` copies every tensor to the
  host first, then hands the files to a writer thread; ``wait()`` joins
  it and raises what the write raised, and every save, asynchronous or
  not, waits for the previous one (one write at a time).

``tree.json`` records each array's name and dtype, where the reference
records its treedef.  A ``TrainState`` flattens to its model's parameters
(``named_parameters`` names), ``m.<name>``, ``v.<name>`` and ``step``; a
dict to its keys, nested dicts joined with ``/``.  A bf16 tensor, which
numpy cannot hold, is stored as its 16 bits (``uint16``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.train.train_step import (TrainState, full_tensors,
                                          shard_state, shard_tensor)


def _sharded(tree: Any) -> bool:
    return isinstance(tree, TrainState) and \
        tree.model.shard_layout is not None


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, tensor or array) pairs of a ``TrainState`` or a nested
    dict, in a fixed order."""
    if isinstance(tree, TrainState):
        named = list(tree.model.named_parameters())
        return (named + [(f"m.{n}", tree.opt.m[n]) for n, _ in named]
                + [(f"v.{n}", tree.opt.v[n]) for n, _ in named]
                + [("step", tree.opt.step)])
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _to_host(x) -> Tuple[np.ndarray, str]:
    """A host copy of x (a device-to-host copy for a device tensor) and its
    dtype's name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(x)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save(self, step: int, tree: Any, *, asynchronous: bool = False):
        """Publish ``tree`` (a ``TrainState`` or a dict of tensors or
        arrays) as step ``step``.  The device-to-host copies are taken here,
        before any thread starts, so training may go on changing the
        tensors.  A sharded state is saved by every rank (collective):
        rank 0 writes, the others return."""
        named = full_tensors(tree) if _sharded(tree) else _flatten(tree)
        if _sharded(tree) and not _writer():
            return
        host = [_to_host(x) for _, x in named]
        names = [n for n, _ in named]
        # one write at a time, a synchronous one too: two writers would
        # race on LATEST.tmp and on the garbage collection
        self.wait()
        if asynchronous:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, names, host))
            self._thread.start()
        else:
            self._write(step, names, host)

    def _write_async(self, step: int, names, host):
        try:
            self._write(step, names, host)
        except Exception as e:        # re-raised by wait()
            self._error = e

    def _write(self, step: int, names, host):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
        meta = {"step": step, "n": len(host), "names": names,
                "dtypes": [d for _, d in host]}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # atomic LATEST pointer
        lt = os.path.join(self.dir, "LATEST.tmp")
        with open(lt, "w") as f:
            f.write(str(step))
        os.replace(lt, os.path.join(self.dir, "LATEST"))
        self._gc()

    def wait(self):
        """Join the write in flight, if any, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The step LATEST names, else the newest published one, else
        None."""
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            s = int(f.read().strip())
        steps = self.all_steps()
        return s if s in steps else (steps[-1] if steps else None)

    def restore(self, step: int, like: Any, device=None, *, mesh=None,
                zero1: bool = True) -> Any:
        """Load step ``step`` into the structure of ``like``.  A
        ``TrainState`` is filled in place (its model's parameters, moments
        and step keep their devices) and returned: a sharded one with its
        rank's slices of the whole arrays; a whole one, given ``mesh``, is
        then sharded onto it (``shard_state(..., zero1=)``) and the sharded
        state returned.  A dict comes back as a new dict of tensors on
        ``device`` (default: each ``like`` tensor's device, the CPU for
        arrays).  A name of ``like`` that the checkpoint lacks, or a shape
        that differs, raises ``ValueError``."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "tree.json")) as f:
            meta = json.load(f)
        index = {n: i for i, n in enumerate(meta["names"])}
        want = _flatten(like)
        missing = [n for n, _ in want if n not in index]
        if missing:
            raise ValueError(f"checkpoint step {step} has no array for "
                             f"{missing[:8]}")
        lay = like.model.shard_layout if _sharded(like) else None
        loaded = []
        for name, dst in want:
            i = index[name]
            a = np.load(os.path.join(d, f"arr_{i}.npy"))
            src = _from_host(a, meta["dtypes"][i])
            if lay is not None and name != "step":
                moment = name[:2] in ("m.", "v.")
                p = lay.params[name[2:] if moment else name]
                if tuple(a.shape) != p.shape:
                    raise ValueError(f"{name}: checkpoint shape {a.shape}, "
                                     f"expected {p.shape}")
                src = shard_tensor(src, p, lay.axes, moment=moment,
                                   zero1=lay.zero1)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: checkpoint shape {a.shape}, "
                                 f"expected {tuple(dst.shape)}")
            loaded.append(src)
        if isinstance(like, TrainState) and mesh is not None:
            if lay is not None:
                raise ValueError("restore(mesh=) takes a whole state; this "
                                 "one is sharded already")
            with torch.no_grad():
                for (_, dst), src in zip(want, loaded):
                    dst.copy_(src)
            return shard_state(like, mesh, zero1=zero1)
        if isinstance(like, TrainState):
            with torch.no_grad():
                for (_, dst), src in zip(want, loaded):
                    dst.copy_(src)
            return like
        out: dict = {}
        for (name, dst), src in zip(want, loaded):
            dev = device if device is not None else (
                dst.device if isinstance(dst, torch.Tensor) else "cpu")
            node = out
            *path, leaf = name.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = src.to(dev)
        return out
