"""The output check of a served model: how far below the reference's best
each served token's logit lies.

For each sampled request, the reference runs once over its prompt and its
served tokens; at each position that chose a served token, the gap is the
reference's largest logit less the reference's logit of that token
(0 where the token is the reference's own greedy choice).  The number
compared is the widest gap.  The control puts the reference, computed in
fp8, in the program's place: at each position the token it ranks first is
read off against the f32 reference the same way.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import seeded
from .reference.common import exact_f32

Tensor = torch.Tensor


class SeededWeights:
    """The reference's view of the seeded weights: one layer's leaf, drawn
    anew in the served type and widened to f32; the unstacked leaves
    (embedding, unembedding, final norm) kept once drawn."""

    def __init__(self, init: Dict, shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype],
                 seed: int, device):
        self.init, self.shapes, self.dtypes = init, shapes, dtypes
        self.seed, self.device = seed, device
        self._kept: Dict[str, Tensor] = {}

    def __call__(self, name: str, layer: Optional[int]) -> Tensor:
        if layer is None and name in self._kept:
            return self._kept[name]
        shape = self.shapes[name][1:] if layer is not None else self.shapes[name]
        t = seeded.draw_leaf(self.init, name, shape, self.dtypes[name], self.device, self.seed,
                             layer).float()
        if layer is None:
            self._kept[name] = t
        return t


def gaps(ref: Tensor, chosen: Tensor) -> Tensor:
    """ref (..., V) f32 logits and chosen (...) token ids -> each gap."""
    return ref.max(dim=-1).values - ref.gather(-1, chosen[..., None].long())[..., 0]


@torch.no_grad()
def served_gaps(logits_fn: Callable, tokens: Tensor, prompt_len: int,
                control: bool = False) -> Dict[str, float]:
    """The gaps of requests ``tokens`` (R, P + G), prompt and served tokens:
    the widest (``gap``), their mean (``gap_mean``) and the share of served
    tokens that are not the reference's own first choice (``flips``);
    ``logits_fn(tokens, start, quant)`` is the reference's, run a row at a
    time.  With ``control`` the same of the
    fp8 reference's first-ranked tokens (``control_*``)."""
    sides = ("", "control_") if control else ("",)
    acc = {side: [0.0, 0.0, 0, 0] for side in sides}  # widest, sum, flips, count

    def add(side, g):
        a = acc[side]
        a[0] = max(a[0], g.max().item())
        a[1] += g.sum().item()
        a[2] += int((g > 0).sum().item())
        a[3] += g.numel()

    with exact_f32():
        for r in range(tokens.shape[0]):
            rows = tokens[r:r + 1]
            inputs, served = rows[:, :-1], rows[:, prompt_len:]
            ref = logits_fn(inputs, prompt_len - 1, None)  # (b, G, V)
            add("", gaps(ref, served))
            if control:
                low = logits_fn(inputs, prompt_len - 1, "fp8")
                add("control_", gaps(ref, low.argmax(dim=-1)))
                del low
            del ref
    out = {}
    for side, (widest, total, flips, n) in acc.items():
        out.update({f"{side}gap": widest, f"{side}gap_mean": total / n, f"{side}flips": flips / n})
    return out
