"""Checkpoint save/load with best-metric rotation.

The torch counterpart of the JAX package's orbax-backed
``checkpoint/manager.py`` (reference utils/checkpoint_utils.py):

  - conditions: save_interval epochs, the best metric (maximized or not),
    keep_last_epochs, keep_best_checkpoints, keep_interval_updates for the
    mid-epoch saves (:35-120);
  - state: whatever dict of tensors and numbers it is given, one
    ``torch.save`` file per top-level key (``Trainer.state_dict()``:
    ``model.pt``, ``ema.pt``, ``optimizer.pt``, ``step.pt``,
    ``generator.pt`` and, under reduce_lr_on_plateau, ``plateau.pt``), plus
    ``<name>.extra.json`` beside the directory (the
    epoch, the iterator's cursor, the meters);
  - layout: ``<save_dir>/checkpoint_{epoch}/`` and
    ``checkpoint_{epoch}_{updates}/``, and ``manifest.json`` with the JAX
    schema (``best``, ``best_metric``, ``epochs``, ``bests``, ``intervals``,
    ``last``).  ``checkpoint_last`` and ``checkpoint_best`` are symbolic
    links to the directories the manifest names, so a path such as
    ``<save_dir>/checkpoint_best`` can be handed to ``cli.validate``.

A directory is written whole under a temporary name and then renamed into
place (``os.replace``), as are the manifest, the extra file and the links:
a directory that exists is complete.  Saves are synchronous; the format is
the port's own and does not read orbax directories.
"""

import json
import logging
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

LINKS = ("checkpoint_last", "checkpoint_best")


class CheckpointManager:
    def __init__(self, cfg, save_dir: Optional[str] = None):
        self.cfg = cfg
        self.save_dir = os.path.abspath(save_dir or cfg.save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._manifest_path = os.path.join(self.save_dir, "manifest.json")
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> Dict[str, Any]:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as fp:
                m = json.load(fp)
                m.setdefault("intervals", [])
                return m
        return {"best": None, "best_metric": None, "epochs": [], "bests": [], "intervals": []}

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    @staticmethod
    def _write_json(path: str, payload) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fp:
            json.dump(payload, fp, indent=2)
        os.replace(tmp, path)

    def _write_manifest(self) -> None:
        self._write_json(self._manifest_path, self.manifest)
        for link, name in zip(LINKS, (self.manifest.get("last"), self.manifest.get("best"))):
            if name:
                tmp = self._path(link + ".tmp")
                if os.path.lexists(tmp):
                    os.remove(tmp)
                os.symlink(name, tmp)
                os.replace(tmp, self._path(link))

    def _write_state(self, name: str, state: Dict[str, Any]) -> None:
        staging = self._path(f".{name}.partial")
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        for key, value in state.items():
            if value is not None:
                torch.save(value, os.path.join(staging, f"{key}.pt"))
        final = self._path(name)
        if os.path.isdir(final):  # a save of the same name replaces it
            shutil.rmtree(final)
        os.replace(staging, final)

    # ------------------------------------------------------------------- save

    def save(
        self,
        epoch: int,
        state: Dict[str, Any],  # Trainer.state_dict()
        extra: Optional[Dict[str, Any]] = None,  # epoch, iterator cursor, meters
        val_metric: Optional[float] = None,
        updates: Optional[int] = None,  # a mid-epoch save at this update count
    ) -> Optional[str]:
        """Save ``state`` as ``checkpoint_{epoch}`` (or, mid-epoch,
        ``checkpoint_{epoch}_{updates}``) and rotate; returns the name, or
        None under ``no_save``."""
        cfg = self.cfg
        if cfg.no_save:
            return None
        # checkpoint_{epoch}_{upd}.pt / checkpoint_{epoch}.pt in the reference
        name = f"checkpoint_{epoch}" if updates is None else f"checkpoint_{epoch}_{updates}"
        if extra is not None:
            self._write_json(self._path(name) + ".extra.json", _jsonable(extra))
        self._write_state(name, state)

        if updates is not None:
            self.manifest["intervals"].append({"name": name, "updates": updates})
            self.manifest["last"] = name
            keep = cfg.keep_interval_updates
            if keep and keep > 0:
                for old in self.manifest["intervals"][:-keep]:
                    self._remove(old["name"])
                self.manifest["intervals"] = self.manifest["intervals"][-keep:]
            self._write_manifest()
            logger.info("saved %s (mid-epoch)", name)
            return name

        self.manifest["epochs"].append({"epoch": epoch, "name": name})
        self.manifest["last"] = name
        maximize = cfg.maximize_best_checkpoint_metric
        if val_metric is not None:
            best = self.manifest.get("best_metric")
            better = (best is None or (maximize and val_metric > best)
                      or (not maximize and val_metric < best))
            if better:
                self.manifest["best_metric"] = float(val_metric)
                self.manifest["best"] = name
            self.manifest["bests"].append({"name": name, "metric": float(val_metric)})
            self.manifest["bests"].sort(key=lambda x: -x["metric"] if maximize else x["metric"])
        self._prune()
        self._write_manifest()
        logger.info("saved %s (val %s)", name, val_metric)
        return name

    def _prune(self) -> None:
        cfg = self.cfg
        keep = {self.manifest.get("best"), self.manifest.get("last")}
        if cfg.keep_best_checkpoints > 0:
            keep.update(b["name"] for b in self.manifest["bests"][: cfg.keep_best_checkpoints])
        if cfg.keep_last_epochs > 0:
            keep.update(e["name"] for e in self.manifest["epochs"][-cfg.keep_last_epochs:])
        for e in list(self.manifest["epochs"]):
            if e["name"] not in keep:
                self._remove(e["name"])
                self.manifest["epochs"].remove(e)

    def _remove(self, name: str) -> None:
        if name in (self.manifest.get("last"), self.manifest.get("best")):
            return
        path = self._path(name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            if os.path.exists(path + ".extra.json"):
                os.remove(path + ".extra.json")

    # ------------------------------------------------------------------- load

    def latest(self) -> Optional[str]:
        """The newest checkpoint whose directory exists: the manifest's
        ``last``, else back through its history."""
        last = self.manifest.get("last")
        if last and os.path.isdir(self._path(last)):
            return last
        for e in reversed(self.manifest.get("intervals", []) + self.manifest.get("epochs", [])):
            if os.path.isdir(self._path(e["name"])):
                return e["name"]
        return None

    def best(self) -> Optional[str]:
        return self.manifest.get("best")

    def load(self, name: str, keys=None) -> Dict[str, Any]:
        """The state saved as ``name`` (CPU tensors), or only its ``keys``."""
        path = self._path(name)
        files = sorted(f[:-3] for f in os.listdir(path) if f.endswith(".pt"))
        return {k: torch.load(os.path.join(path, f"{k}.pt"), map_location="cpu", weights_only=True)
                for k in files if keys is None or k in keys}

    def load_extra(self, name: str) -> Dict[str, Any]:
        p = self._path(name) + ".extra.json"
        if os.path.exists(p):
            with open(p) as fp:
                return json.load(fp)
        return {}

    def finalize(self) -> None:
        """Nothing in flight: saves are synchronous (the JAX manager's async
        writes wait here)."""


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x
