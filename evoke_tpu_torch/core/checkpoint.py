"""Run checkpoints and cross-stage partial weight loads (the port's
counterpart of ``evoke_tpu/core/checkpoint.py``).

``CheckpointManager`` keeps two slots under a run's ``checkpoint/`` directory,
as the reference does (``current`` every ``save_period`` epochs, ``best`` on
monitor improvement; trainer_v0401.py:160-176):

    {dir}/current/state.pt   {dir}/current.meta.json
    {dir}/best/state.pt      {dir}/best.meta.json

``state.pt`` is a ``torch.save`` of ``TrainState.state_dict()``: the float32
parameters, the BatchNorm statistics, the optimizer's moments and counters and
the step. ``meta.json`` holds {epoch, monitor_best, scheduler}. The format is
the port's own: it does not read the JAX package's orbax checkpoints (carry
JAX weights over with ``params.flax_to_state_dict`` + ``save_state_dict``).

A save copies the state to the host synchronously and, with
``async_save=True``, writes it on a background thread while training goes
on; saves are serialised, and a slot's file is replaced atomically (written
beside it, then renamed), so a run cut mid-save keeps its previous slot.

The reference seeds a stage from another stage's weights with
``load_state_dict(strict=False)`` (trainer_v0401.py:191-202):
``partial_restore`` loads every entry whose name and shape match and leaves
the rest; ``partial_restore_from`` reads a slot directory or a ``torch.save``
file of a flat state dict.

A checkpoint holds full tensors whatever the mesh: under tensor parallelism
(``parallel/tp.py``) the split parameters and their optimizer moments are
gathered over ``mp`` before rank 0 writes, and a restore takes each rank's
slice of the full tensors. A checkpoint written at ``dp=2 x mp=2`` restores
into one device, and one written on one device restores at ``dp=2 x mp=2``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from evoke_tpu_torch.parallel.collectives import barrier, broadcast_, gather_objects
from evoke_tpu_torch.parallel.tp import full_shape, gather_full, local_slice

STATE_FILE = "state.pt"


def save_state_dict(state_dict: Mapping[str, object], path: str) -> None:
    """``torch.save`` a flat state dict, numpy values as tensors (so the file
    loads with ``weights_only=True``)."""
    torch.save({k: torch.from_numpy(np.array(v)) if not torch.is_tensor(v) else v
                for k, v in state_dict.items()}, path)


def _to_host(tree):
    """A host copy of every tensor in a nested dict (taken now)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _replace_file(write, path: str) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Slots ``current`` and ``best`` under ``directory`` (see the module
    docstring). ``async_save`` writes on a background thread; ``wait()``
    joins it and raises what it raised.

    ``mesh`` (a ``core/mesh.Mesh`` whose dp ranks hold identical states):
    rank 0 writes and every rank waits for the write (saves are synchronous
    then); a restore reads the slot on rank 0 and broadcasts the state and
    the meta to every rank; ``async_save`` with a mesh raises. With mp > 1
    every rank takes part in gathering the full tensors before rank 0
    writes, and takes its slice of them at a restore."""

    def __init__(self, directory: str, async_save: bool = False, mesh=None):
        if async_save and mesh is not None:
            raise ValueError("CheckpointManager: async_save under a dp mesh is not supported "
                             "(rank 0 writes while every rank waits)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _slot(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, names, state, meta: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` (a ``TrainState`` or anything with ``state_dict()``)
        into the slot ``names`` (a name or a tuple of names: one write, the
        other slots hard-linked to it) with ``meta``."""
        names = (names,) if isinstance(names, str) else tuple(names)
        self.wait()                      # serialise in-flight saves
        full = _full_state_dict(state)   # every mp rank gathers its split tensors
        if not self.writer:
            barrier(self.mesh)           # rank 0 is writing
            return
        host = _to_host(full)
        meta = dict(meta or {})

        def write():
            first = None
            for name in names:
                slot = self._slot(name)
                os.makedirs(slot, exist_ok=True)
                path = os.path.join(slot, STATE_FILE)
                if first is None:
                    _replace_file(lambda p: torch.save(host, p), path)
                    first = path
                else:
                    _replace_file(lambda p: _link_or_copy(first, p), path)
                _replace_file(lambda p: _write_json(meta, p), slot + ".meta.json")

        if not self.async_save:
            write()
            if self.mesh is not None:
                barrier(self.mesh)
            return

        def run():
            try:
                write()
            except BaseException as e:    # re-raised by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-save", daemon=False)
        self._thread.start()

    def exists(self, name: str) -> bool:
        self.wait()
        return os.path.isfile(os.path.join(self._slot(name), STATE_FILE))

    def restore(self, name: str, state) -> Dict[str, Any]:
        """Full restore of slot ``name`` into ``state``: a ``TrainState``, or
        a module, which takes the parameters and buffers only (strict).
        Returns the slot's meta."""
        self.wait()
        slot = self._slot(name)
        if self.mesh is not None:
            return _restore_on_mesh(os.path.join(slot, STATE_FILE), slot + ".meta.json", state,
                                    self.mesh, self.writer)
        blob = torch.load(os.path.join(slot, STATE_FILE), map_location="cpu", weights_only=True)
        if isinstance(state, torch.nn.Module):
            state.load_state_dict({**blob["params"], **blob["buffers"]}, strict=True)
        else:
            state.load_state_dict(blob)
        return _read_meta(slot + ".meta.json")


def _read_meta(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _model_of(state) -> torch.nn.Module:
    return state if isinstance(state, torch.nn.Module) else state.model


_OPT_SLOTS = ("mu", "nu", "nu_max", "acc")


def _map_split(d, model, fn):
    """``d`` (a module's state dict or a ``TrainState.state_dict()``) with
    ``fn(tensors, model)`` applied to every name -> tensor mapping keyed by
    the model's state-dict names."""
    if "params" not in d:
        return fn(d, model)
    d = dict(d, params=fn(d["params"], model), buffers=fn(d["buffers"], model))
    d["opt"] = dict(d["opt"], **{k: fn(d["opt"][k], model) for k in _OPT_SLOTS
                                 if k in d["opt"]})
    return d


def _full_state_dict(state):
    """``state.state_dict()`` with the split tensors gathered over mp."""
    return _map_split(state.state_dict(), _model_of(state), gather_full)


def _restore_on_mesh(path, meta_path, state, mesh, writer):
    """Restore under a mesh: rank 0 reads the full tensors and checks them
    against every rank's state, each is broadcast to every rank in turn, and
    every rank keeps its slice (the whole tensor where it is replicated)."""
    model = _model_of(state)
    local = state.state_dict()
    blob, meta, problem = None, {}, None
    if writer:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        meta = _read_meta(meta_path)
        problem = _check_full(local, blob, model)
    meta, problem, scalars = gather_objects(
        (meta, problem, _scalars(blob) if writer else None), mesh)[0]
    if problem:
        raise KeyError(f"checkpoint {path}: {problem}")

    def fill(tensors, src):
        out = {}
        for k, t in tensors.items():
            buf = (src[k].to(t.device, t.dtype).contiguous() if writer
                   else torch.empty(full_shape(model, k, t.shape), dtype=t.dtype,
                                    device=t.device))
            broadcast_([buf], mesh)
            out[k] = local_slice(model, k, buf)
        return out

    if "params" not in local:
        model.load_state_dict(fill(local, {**blob["params"], **blob["buffers"]}
                                   if writer else None), strict=True)
        return meta
    d = dict(scalars, params=fill(local["params"], blob and blob["params"]),
             buffers=fill(local["buffers"], blob and blob["buffers"]))
    d["opt"] = dict(scalars["opt"], **{k: fill(local["opt"][k], blob and blob["opt"][k])
                                       for k in _OPT_SLOTS if k in local["opt"]})
    state.load_state_dict(d)
    return meta


def _scalars(blob):
    """The non-tensor entries of a ``TrainState`` checkpoint (step, the
    optimizer's counters)."""
    if "params" not in blob:
        return {}
    return {"step": blob["step"], "opt": {k: v for k, v in blob["opt"].items()
                                          if k not in _OPT_SLOTS}}


def _check_full(local, blob, model):
    """What is wrong with ``blob`` as the full tensors of ``local`` (a rank's
    state dict of ``model``), or None."""
    pairs = ([(local, {**blob["params"], **blob["buffers"]})] if "params" not in local else
             [(local["params"], blob["params"]), (local["buffers"], blob["buffers"])]
             + [(local["opt"][k], blob["opt"].get(k, {})) for k in _OPT_SLOTS
                if k in local["opt"]])
    for want, have in pairs:
        for k, t in want.items():
            shape = full_shape(model, k, t.shape)
            if k not in have or tuple(have[k].shape) != shape:
                return (f"{k}: {tuple(have[k].shape) if k in have else 'missing'}, the mesh "
                        f"needs {shape} in full")
    return None


def _write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def load_source(path: str) -> Dict[str, Any]:
    """A flat name -> tensor dict from a checkpoint slot directory (its
    float32 parameters and buffers) or a ``torch.save``d state dict file."""
    if os.path.isdir(path):
        blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
        return {**blob["params"], **blob["buffers"]}
    source = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(source, Mapping):
        raise TypeError(f"{path}: expected a state dict, got {type(source).__name__}")
    return dict(source)


def partial_restore(source: Mapping[str, object], module: torch.nn.Module,
                    opt=None) -> Dict[str, int]:
    """Copy every ``source`` entry whose name and shape match ``module``'s
    state dict into it (cast to the target's dtype and device); with ``opt``
    (a ``train.optim.Optimizer`` of ``module``) the loaded parameters also
    set its float32 masters. Returns counts: ``loaded``; ``missing`` (target
    entries the source lacks); ``skipped`` (source entries not loaded:
    unknown names or other shapes)."""
    target = module.state_dict()
    merged = {}
    for key, tgt in target.items():
        src = source.get(key)
        # a tensor-parallel module takes its slice of the full tensor
        if src is not None and tuple(np.shape(src)) == full_shape(module, key, tgt.shape):
            merged[key] = local_slice(module, key, torch.as_tensor(
                np.asarray(src) if not torch.is_tensor(src) else src))
    module.load_state_dict(merged, strict=False)
    if opt is not None:
        opt.load_masters({k: v.float() for k, v in merged.items()})
    return {"loaded": len(merged), "missing": len(set(target) - set(source)),
            "skipped": len(source) - len(merged)}


def partial_restore_from(path: str, module: torch.nn.Module, opt=None) -> Dict[str, int]:
    """``partial_restore`` from a slot directory or a state dict file."""
    return partial_restore(load_source(path), module, opt)
