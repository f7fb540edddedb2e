"""ImageNet-1k class-name table (EN + CN) and lookup helpers.

The table itself is public data (the standard ImageNet-1k synset names with
Chinese translations) stored as a JSON asset; the reference ships the same
data as a Python dict (ref tools/imagenet_en_cn.py:1-1001) and uses it in the
gradio demo's class picker. Lookups here additionally power `cli.py sample`
class-name sugar (pass "goldfish" instead of 1). The port's copy of the JAX
package's `data/imagenet_labels.py`, with its own copy of the asset.
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Tuple

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "imagenet_classes.json")


@lru_cache(maxsize=1)
def imagenet_classes() -> Dict[int, str]:
    """class id -> 'english name(s) [chinese]' (1000 entries)."""
    with open(_ASSET, encoding="utf-8") as f:
        return {int(k): v for k, v in json.load(f).items()}


def class_name(class_id: int, english_only: bool = False) -> str:
    name = imagenet_classes()[int(class_id)]
    if english_only:
        name = re.sub(r"\s*\[.*\]$", "", name)
    return name


def english_names(class_id: int) -> List[str]:
    """All english synonyms for a class id."""
    return [s.strip() for s in class_name(class_id, english_only=True).split(",")]


def lookup_class(query: str) -> int:
    """Resolve a class name (or numeric string) to a class id.

    Exact synonym match wins; otherwise a unique case-insensitive substring
    match is accepted. Raises ValueError on no match / ambiguity.
    """
    q = query.strip().lower()
    if q.isdigit():
        cid = int(q)
        if not 0 <= cid < 1000:
            raise ValueError(f"class id {cid} out of range [0, 1000)")
        return cid
    exact: List[int] = []
    partial: List[Tuple[int, str]] = []
    for cid in range(1000):
        for syn in english_names(cid):
            s = syn.lower()
            if s == q:
                exact.append(cid)
            elif q in s:
                partial.append((cid, syn))
    if exact:
        return exact[0]
    if len(partial) == 1:
        return partial[0][0]
    if not partial:
        raise ValueError(f"no ImageNet class matches {query!r}")
    opts = ", ".join(f"{c}:{s}" for c, s in partial[:8])
    raise ValueError(f"ambiguous class {query!r}; candidates: {opts}")
