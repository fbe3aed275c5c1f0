"""A configuration file (``perfbench/configs/<name>.json``) read into what
the harness needs: the target and the draft, each as its architecture's
module and dims, and the deployment.

The file keeps the target's published ``config.json`` keys at its top
level and the draft's under ``draft``; ``reduced`` names every key changed
from the source, ``assumed`` what the source leaves unsaid, and
``deployment`` how the pair is served.  A model's architecture is its
section's published ``architectures`` key: the module for it is
``perfbench/arch/<architectures[0] lowercased>.py``, which reads the
section's other keys.  A module provides:

* ``model(hf, name, assumed)``: a frozen dims object with at least
  ``layers`` and ``vocab``;
* ``leaf_shapes(m)`` and ``norm_shapes(m)``: ``(name, shape)`` of every
  matrix, bias and embedding, and of every norm scale (``lib/weights.py``);
* ``port_config(m, dtype)`` and ``port_tree(m, raw)``: the port's
  ``ModelConfig`` and parameter tree over the raw weights;
* ``Reference(m, raw, device, fp8=False)`` with ``logits_at(seqs,
  positions)``: the plain forward in float32 with TF32 off, and with
  ``fp8`` the W8A8 control (``reference/plain.py``);
* ``forward_flops(m, pos, T, lm_tokens)``: one row's window of T tokens
  at ``pos`` (``costs/model.py`` composes the round's work from it);
* ``attention_layers(m)``: one ``(heads, kv_heads, head_dim, window)`` per
  layer, ``window`` None for full attention (``costs/paged_attention.py``).

It imports ``torch`` and nothing of the program at module level.
"""

from __future__ import annotations

from types import ModuleType
from typing import NamedTuple

from .manifest import BENCH, load_module

ARCH = BENCH / "arch"


class Model(NamedTuple):
    """One model of a configuration: its architecture's module and the
    dims that module read from the model's section."""

    arch: ModuleType
    dims: object


def arch(section: dict) -> ModuleType:
    """The module of a model section's ``architectures[0]``."""
    names = section.get("architectures")
    if not names:
        raise KeyError("a model section needs its published "
                       "'architectures' key")
    path = ARCH / f"{names[0].lower()}.py"
    if not path.is_file():
        present = sorted(p.name for p in ARCH.glob("*.py"))
        raise LookupError(f"architectures {names[0]!r}: no module "
                          f"{path.name} in {ARCH}; present: {present}")
    return load_module(path, "perfbench_arch_" + path.stem)


def _model(section: dict, name: str, assumed: dict) -> Model:
    mod = arch(section)
    return Model(mod, mod.model(section, name, assumed))


def models(cfg: dict) -> tuple[Model, Model]:
    """``(target, draft)`` of a configuration file."""
    return (_model(cfg, cfg["target_name"], cfg["assumed"]),
            _model(cfg["draft"], cfg["draft"]["name"], cfg["assumed"]))
