"""Per-stage checkpoints of the distributed plan (port of the JAX package's
``parallel/checkpoint.py``).

The reference's computation resumes by phase: every merge phase writes its
whole state as segment files and its inputs are deleted only after the
round that reads them.  The distributed plan's stage outputs checkpoint the
same way: each process saves its own shards of a stage (an npz and its
meta), a manifest marks the stage done after every process saved, and a
re-run loads every stage the manifest marks done and runs only the rest.

Unlike the JAX form, :meth:`StageCheckpoints.cleanup` removes only this
process's own ``*.p{pid}.*`` files (process 0 also the manifest), never
another process's: two processes that finish together must not unlink each
other's shards.
"""

from __future__ import annotations

import json
import os
import pathlib
import zlib

import numpy as np
import torch


def local_content_tag(tensors) -> str:
    """CRC over the given tensors (this process's input shards, in order):
    the per-process fingerprint of a run's input content."""
    h = 0
    for t in tensors:
        h = zlib.crc32(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes(), h)
    return f"{h:08x}"


class StageCheckpoints:
    """The per-stage checkpoint store of one run of the plan over `mesh`.

    Layout: ``<dir>/manifest.json`` ({"done": [stage, ...], "fingerprint":
    ...}, written by process 0 after every process saved),
    ``<dir>/<stage>.p<pid>.npz`` (this process's shards of each tensor,
    stacked) and ``.meta.json`` (the shards' global indices, the
    content tag and host scalars).
    """

    def __init__(self, ckpt_dir: str, mesh, fingerprint: dict | None = None,
                 local_tag: str = ""):
        """``fingerprint`` identifies the run (input shapes, field, the
        plan's settings; the same on every process) and is pinned in the
        manifest; ``local_tag`` hashes this process's input shards and is
        pinned in its meta.  A stage saved under another fingerprint or
        content tag is not resumed: a reused directory never serves another
        run's intermediates, even of the same shapes."""
        self.dir = pathlib.Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.pid = mesh.process_index
        self.nproc = mesh.process_count
        self.manifest_path = self.dir / "manifest.json"
        self.fingerprint = fingerprint or {}
        self.local_tag = local_tag

    def _path(self, stage: str, suffix: str) -> pathlib.Path:
        return self.dir / f"{stage}.p{self.pid}.{suffix}"

    def _manifest(self) -> dict:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {"done": [], "fingerprint": self.fingerprint}

    def _stage_done_local(self, stage: str) -> bool:
        m = self._manifest()
        if m.get("fingerprint") != self.fingerprint or stage not in m["done"]:
            return False
        meta_p = self._path(stage, "meta.json")
        if not (self._path(stage, "npz").exists() and meta_p.exists()):
            return False
        meta = json.loads(meta_p.read_text())
        return (meta.get("local_tag", "") == self.local_tag
                and meta.get("shards") == list(self.mesh.local_shards))

    def _all(self, ok: bool) -> bool:
        """True where every process says so (a minimum over the group)."""
        if self.nproc == 1:
            return ok
        import torch.distributed as dist

        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self.mesh.devices[0])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.mesh.group)
        return bool(int(flag) == 1)

    def stage_done(self, stage: str) -> bool:
        """The skip decision, the same on every process: a stage's
        collectives would wait forever if one process skipped it and another
        ran it, so it counts as done only where every process has it."""
        return self._all(self._stage_done_local(stage))

    def _barrier(self) -> None:
        """Every process reaches here before process 0 marks a stage done."""
        self._all(True)

    def _mark_done(self, stage: str) -> None:
        m = self._manifest()
        if m.get("fingerprint") != self.fingerprint:
            m = {"done": [], "fingerprint": self.fingerprint}
        if stage not in m["done"]:
            m["done"].append(stage)
        tmp = self.manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(m))
        os.replace(tmp, self.manifest_path)

    def save_stage(self, stage: str, tensors: dict, scalars: dict | None = None) -> None:
        """Save this process's shards of each named value (a list of one
        tensor a local shard, all of one shape) and host scalars; process 0
        marks the stage done once every process saved."""
        meta = {"shards": list(self.mesh.local_shards), "scalars": scalars or {},
                "local_tag": self.local_tag}
        local = {name: np.stack([t.detach().cpu().numpy() for t in parts])
                 for name, parts in tensors.items()}
        tmp = self._path(stage, "npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **local)
        os.replace(tmp, self._path(stage, "npz"))
        self._path(stage, "meta.json").write_text(json.dumps(meta))
        self._barrier()
        if self.pid == 0:
            self._mark_done(stage)
        self._barrier()

    def load_stage(self, stage: str) -> dict:
        """The stage's values: a list of one tensor a local shard, each on
        its shard's device."""
        data = np.load(self._path(stage, "npz"))
        return {name: [torch.as_tensor(data[name][j]).to(dev)
                       for j, dev in enumerate(self.mesh.devices)]
                for name in data.files}

    def load_scalars(self, stage: str) -> dict:
        return json.loads(self._path(stage, "meta.json").read_text()).get("scalars", {})

    def cleanup(self) -> None:
        """Remove this process's files (process 0 also the manifest), and no
        other process's."""
        for f in self.dir.glob(f"*.p{self.pid}.*"):
            f.unlink(missing_ok=True)
        if self.pid == 0:
            self.manifest_path.unlink(missing_ok=True)


class InjectedStageFailure(SystemExit):
    """Fault injection: a deliberate death (exit 17) after a named stage
    checkpointed."""

    def __init__(self, stage: str):
        super().__init__(17)
        self.stage = stage
