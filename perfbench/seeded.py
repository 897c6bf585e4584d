"""Weights and inputs made from ``--seed``, the same for the program and the reference.

Every leaf of a model (a parameter, by its name in the port's module, e.g.
``blocks.attn.wq``) is drawn on the device by a rule of the configuration's
``init`` table.  A stacked leaf (L, ...) is drawn layer by layer, each layer
from a generator of its own, seeded by (seed, leaf, layer): so the reference
can draw any one layer alone, and gets the same bits as the program's copy.
Draws are made in the leaf's own type (the served type), on the device.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import torch


def sub_seed(seed: int, *what: Any) -> int:
    """A 63-bit seed for the stream ``what`` of run ``seed``."""
    text = "|".join(str(w) for w in (seed, *what)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def generator(device, seed: int, *what: Any) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *what))


def rule_for(init: Dict[str, list], name: str) -> list:
    """The rule of leaf ``name``: its own entry, else its last part's."""
    rule = init.get(name) or init.get(name.rsplit(".", 1)[-1])
    if rule is None:
        raise KeyError(f"the configuration's init table has no rule for {name!r}")
    return rule


@torch.no_grad()
def draw_into(t: torch.Tensor, rule: list, g: torch.Generator) -> torch.Tensor:
    """Fills ``t`` in place by ``rule``: ["normal", mean, std],
    ["log_uniform", lo, hi] (the log of a uniform draw), or
    ["inv_softplus_uniform", lo, hi] (x with softplus(x) uniform)."""
    kind, *args = rule
    if kind == "normal":
        t.normal_(args[0], args[1], generator=g)
    elif kind == "log_uniform":
        t.uniform_(args[0], args[1], generator=g).log_()
    elif kind == "inv_softplus_uniform":
        u = torch.empty(t.shape, dtype=torch.float32, device=t.device).uniform_(
            args[0], args[1], generator=g)
        t.copy_(u + torch.log(-torch.expm1(-u)))
    else:
        raise ValueError(f"unknown init rule {rule!r}")
    return t


def stacked(name: str) -> bool:
    """Whether a leaf holds its layers stacked on dim 0 (the port's
    ``blocks.*``)."""
    return name.startswith("blocks.")


def draw_leaf(init: Dict[str, list], name: str, shape, dtype, device, seed: int,
              layer: Optional[int] = None) -> torch.Tensor:
    """Leaf ``name`` (or, for a stacked leaf, its ``layer``; ``shape`` is then
    one layer's) drawn anew."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return draw_into(t, rule_for(init, name), generator(device, seed, name, layer))


@torch.no_grad()
def fill_module(module: torch.nn.Module, init: Dict[str, list], seed: int) -> None:
    """Every parameter of ``module`` (materialised, on its device) drawn by
    its rule: a stacked leaf layer by layer."""
    for name, p in module.named_parameters():
        rule = rule_for(init, name)
        if stacked(name):
            for i in range(p.shape[0]):
                draw_into(p[i], rule, generator(p.device, seed, name, i))
        else:
            draw_into(p, rule, generator(p.device, seed, name, None))


def prompts(seed: int, k: int, batch: int, length: int, vocab: int, device) -> torch.Tensor:
    """Batch ``k``'s prompt tokens (batch, length), uniform over the vocabulary."""
    g = generator(device, seed, "prompt", k)
    return torch.randint(0, vocab, (batch, length), generator=g, device=device)


def train_tokens(seed: int, step: int, batch: int, seq: int, vocab: int, device) -> torch.Tensor:
    """Step ``step``'s rows (batch, seq + 1), uniform over the vocabulary;
    no two steps' rows alike."""
    g = generator(device, seed, "rows", step)
    return torch.randint(0, vocab, (batch, seq + 1), generator=g, device=device)
