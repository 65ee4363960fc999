"""Small shared utilities.

Counterpart of ``qml_essentials_tpu/utils/__init__.py``: JAX PRNG keys
become explicit ``torch.Generator`` objects.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def safe_random_split(
    generator: Optional[torch.Generator], num: int = 2, device=None
) -> Union[Tuple[None, ...], Tuple[torch.Generator, ...]]:
    """Derive *num* independent generators from *generator*.

    Each child is seeded with one 63-bit draw of the parent, so the parent
    advances and the children do not share its stream.  The children live
    on *device* (the CPU by default; a draw on the card needs a generator
    there).  ``None`` flows through as a tuple of ``None`` (noise-free
    circuits never draw).
    """
    if generator is None:
        return (None,) * num
    seeds = torch.randint(
        0, 2**63 - 1, (num,), generator=generator, dtype=torch.int64,
        device=generator.device,
    ).tolist()
    return tuple(
        torch.Generator(device=device or "cpu").manual_seed(int(s)) for s in seeds
    )
