"""Checkpoint and resume for scenes and training state.

The reference persists only through Unity asset serialization (SURVEY.md
§5: ScriptableObjects and scene YAML; no runtime checkpointing). The
gradient workload needs real save and restore: the learnable materials
(``SceneParams``), the optimizer's ``state_dict()`` and the step. A
checkpoint is one ``torch.save`` file in a directory, read back with
``torch.load(weights_only=True)``: dataclasses of tensors (scenes,
parameters) are stored as dicts of their fields and rebuilt from the
example tree on restore.

The JAX package's orbax or pickle checkpoints are not read (its pickle
holds a JAX tree definition); carry a JAX run across with
``convert.params_from_arrays`` and ``convert.adam_from_arrays``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import torch

FILE = "checkpoint.pt"


def _plain(tree):
    """``tree`` with every dataclass as a dict of its fields and every
    tensor detached on the CPU: what ``weights_only`` loading accepts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree):
        return {f.name: _plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _rebuild(saved, example):
    """``saved`` in the structure of ``example``: dataclasses rebuilt,
    each tensor on its example's device and dtype. A tensor without a
    counterpart in ``example`` stays on the CPU (the per-parameter state
    of an optimizer, which a fresh optimizer lacks:
    ``Optimizer.load_state_dict`` moves it to its parameter's device)."""
    if isinstance(example, torch.Tensor):
        return saved.to(device=example.device, dtype=example.dtype)
    if dataclasses.is_dataclass(example):
        return type(example)(**{
            f.name: _rebuild(saved[f.name], getattr(example, f.name))
            for f in dataclasses.fields(example)})
    if isinstance(saved, dict):
        ex = example if isinstance(example, dict) else {}
        return {k: _rebuild(v, ex.get(k)) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        ex = example if isinstance(example, (list, tuple)) \
            and len(example) == len(saved) else [None] * len(saved)
        return type(saved)(_rebuild(v, e) for v, e in zip(saved, ex))
    return saved


def save_checkpoint(path: str | os.PathLike, tree) -> pathlib.Path:
    """Save ``tree`` (dicts, lists and dataclasses of tensors, an
    optimizer's ``state_dict()``, numbers) into the directory ``path``,
    replacing an earlier checkpoint there; returns the file written."""
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (FILE + ".tmp")
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path / FILE)  # a reader never sees a half-written file
    return path / FILE


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)`` keeping the optimizer's
    own ``capturable`` and ``fused``: a state saved by a run on the CPU
    resumes in a capturable Adam on the card (its step counts moved onto
    the parameters' device, as a captured step needs them), and one saved
    on the card resumes on the CPU. ``load_state_dict`` alone takes both
    flags from the saved groups."""
    own = [{k: g[k] for k in ("capturable", "fused") if k in g}
           for g in optimizer.param_groups]
    groups = [dict(saved, **mine)
              for saved, mine in zip(state_dict["param_groups"], own)]
    optimizer.load_state_dict(dict(state_dict, param_groups=groups))


def restore_checkpoint(path: str | os.PathLike, example_tree):
    """Restore the checkpoint in the directory ``path`` into the
    structure of ``example_tree``, each tensor on the device and dtype
    of its counterpart there."""
    saved = torch.load(pathlib.Path(path).absolute() / FILE,
                       map_location="cpu", weights_only=True)
    return _rebuild(saved, example_tree)
