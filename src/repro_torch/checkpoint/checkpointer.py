"""Checkpointing: atomic, checksummed, async (counterpart of
``repro/checkpoint/checkpointer.py``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, written to a
``.tmp_step_<n>`` directory and renamed into place (atomic commit); the
manifest holds the sha256 of every array, its shape and its dtype. Arrays
are keyed by the ``/``-joined key path of their leaf
(``repro_torch.tree.paths``: dict keys, list indices), the keys the
reference writes for the same tree — the port's param and AdamW-state
layouts are the reference's leaf for leaf — so either package restores a
checkpoint the other wrote. numpy has no bfloat16: a bfloat16 leaf is
stored widened to float32 (exact) and restored at the target's dtype.

On a DP×TP mesh every rank calls ``save`` with its shards and their specs:
the shards are gathered (``sharding.gather_params``), rank 0 writes the
same full arrays, and a blocking save returns on every rank once they are
on disk. Every rank restores the full arrays;
``distributed.fault_tolerance.elastic_restore`` shards them onto a mesh,
any mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed import sharding as shd


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _keys(t) -> List[str]:
    return ["/".join(str(k) for k in p) for p in tree.paths(t)]


def _flatten(t) -> Dict[str, np.ndarray]:
    return dict(zip(_keys(t), (_host(x) for x in tree.leaves(t))))


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None
        # Crash-leftover sweep: a save killed mid-write leaves its
        # .tmp_step_* dir behind (the rename never happened); no reader
        # ever sees one, so reclaim the disk on startup.
        for name in os.listdir(directory):
            if name.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True, *,
             mesh=None, specs=None) -> None:
        """Write `state` (a tree of tensors or arrays) as step `step`. The
        device-to-host copy happens here, synchronously; with
        ``blocking=False`` the write runs on a thread and its error
        surfaces at the next ``wait``. On a multi-rank `mesh` every rank
        calls it with its shards of `state` and `specs` (a spec tree of
        `state`, ``sharding.param_specs``'s): rank 0 writes the gathered
        full arrays, and a blocking save ends at a barrier after the
        write."""
        on_mesh = mesh is not None and mesh.size > 1
        if on_mesh:
            state = shd.gather_params(state, specs, mesh)
            if mesh.rank != 0:
                if blocking:
                    dist.barrier()
                return
        flat = _flatten(state)
        if blocking:
            self._write(step, flat)
            if on_mesh:
                dist.barrier()
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_safe, args=(step, flat), daemon=True)
            self._thread.start()

    def _write_safe(self, step: int, flat) -> None:
        try:
            self._write(step, flat)
        except Exception as e:  # noqa: BLE001 — surfaced on next wait()
            self.last_error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "checksums": {k: _checksum(v) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def verify(self, step: int) -> bool:
        """True iff step's manifest parses and every array matches its
        sha256 — the integrity predicate behind ``latest_valid_step``."""
        d = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                checksums = json.load(f)["checksums"]
            with np.load(os.path.join(d, "arrays.npz")) as data:
                if set(data.files) != set(checksums):
                    return False
                return all(_checksum(data[k]) == checksums[k]
                           for k in data.files)
        except Exception:  # noqa: BLE001 — an unreadable step is invalid
            return False

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes ``verify`` — the restore entry point for
        callers that must survive a corrupt or truncated checkpoint
        (trainer restarts, the serving runtime's hot reload)."""
        for step in reversed(self.steps()):
            if self.verify(step):
                return step
        return None

    def restore(self, step: int, target: Any) -> Any:
        """Restore step `step` into the structure of `target` (a tree of
        tensors): each leaf comes back as a tensor on its target's device
        and at its dtype. Raises ``IOError`` on a checksum mismatch."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            checksums = json.load(f)["checksums"]
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            data = {k: npz[k] for k in npz.files}
        for k, v in data.items():
            if _checksum(v) != checksums[k]:
                raise IOError(f"checkpoint corruption in {k!r} at step "
                              f"{step}")
        out = []
        for key, leaf in zip(_keys(target), tree.leaves(target)):
            arr = torch.from_numpy(np.array(data[key]))
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(device=leaf.device, dtype=leaf.dtype)
            out.append(arr)
        return tree.unflatten(target, out)
