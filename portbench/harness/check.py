"""The numbers `correct` compares, each beside its limit.

- `logit_gap_mean`: for every image token the program emitted, how far its
  logit lies below the reference's best, on the reference's CFG-mixed logits
  given the same prefix (for a sampled token, on logit / temperature plus
  the request's documented Gumbel noise, over the reference's top-k); the
  mean over the sample's tokens. (The widest gap is printed beside it: it is
  the largest rounding flip among thousands of tokens, and the program's
  own lower-precision path reads only 2-3 times the bf16 program there.)
- `pixel_err`: how far a decoded pixel (0..255) of the program lies from the
  reference's decode of the same tokens, beyond the 0.5 of rounding.
- `loss_gap`: the largest relative gap of a training step's loss.
- `grad_gap`, `update_gap`: per leaf, the gap between the program's norm
  and the reference's, over the larger of the reference leaf's norm and the
  median leaf's; the worst leaf. Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (they move by round-off).
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

Number = Tuple[str, float, float]  # (name, value, limit)


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor,
               noise: Optional[torch.Tensor] = None, top_k: int = 0,
               temperature: float = 1.0) -> torch.Tensor:
    """ref_logits (N, V) fp32, tokens (N,) -> (N,) gaps >= 0. With noise
    (N, V), the score is logit / temperature + noise over the reference's
    top_k entries; the emitted token's own score is taken unmasked."""
    score = ref_logits.float()
    if noise is not None:
        score = score / temperature + noise
        if top_k:
            kth = torch.topk(ref_logits, top_k, dim=-1).values[:, -1:]
            best = score.masked_fill(ref_logits < kth, float("-inf")).amax(-1)
        else:
            best = score.amax(-1)
    else:
        best = score.amax(-1)
    own = score.gather(-1, tokens.long()[:, None])[:, 0]
    return (best - own).clamp(min=0)


def gap_number(gaps: List[torch.Tensor], limits: dict) -> Number:
    """The mean gap over every checked token; the widest printed beside it."""
    every = torch.cat([g.reshape(-1) for g in gaps])
    print(f"portbench check: logit_gap_widest {float(every.max())!r} (not compared)",
          file=sys.stderr)
    return ("logit_gap_mean", float(every.mean()), limits.get("logit_gap_mean", 0.0))


def pixel_err(program_u8: torch.Tensor, ref_pixels: torch.Tensor) -> float:
    return max(0.0, float((program_u8.float() - ref_pixels).abs().max()) - 0.5)


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[List[str]] = None) -> Tuple[float, str]:
    """Worst leaf's |program - reference| / max(reference, median leaf)."""
    names = keep if keep is not None else list(reference)
    med = statistics.median(reference[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(program[n] - reference[n]) / max(reference[n], med)
        if gap > worst:
            worst, at = gap, n
    return worst, at


def moved_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    live = [v for v in ref_grad_norms.values() if v > 0]
    med = statistics.median(live)
    return [n for n, v in ref_grad_norms.items() if v >= 1e-3 * med]


def compared(readings: List[Tuple[str, float]], limits: dict) -> List[Number]:
    """The readings with their limits. A limit given as null in the limits
    file marks a number with no control reading to set a limit from: it is
    printed, not compared. A number with no entry has the limit 0."""
    out = []
    for name, value in readings:
        if name in limits and limits[name] is None:
            print(f"portbench check: {name} {value!r} (not compared)", file=sys.stderr)
        else:
            out.append((name, value, limits.get(name, 0.0)))
    return out


def verdict(numbers: List[Number], failed: int) -> bool:
    ok = failed == 0
    for name, value, limit in numbers:
        ok &= value == value and value <= limit  # NaN fails
    return bool(ok)


def print_numbers(numbers: List[Number], failed: int, attempted: int) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    print(f"portbench check: failed {failed} of {attempted} attempted (limit 0)", file=sys.stderr)
    for name, value, limit in numbers:
        print(f"portbench check: {name} {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
