"""Small shared utilities.

Counterpart of ``qml_essentials_tpu/utils/__init__.py``: JAX PRNG keys
become explicit ``torch.Generator`` objects.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch


class GeneratorBatch:
    """One ``torch.Generator`` per element of a batch that is recorded as
    one tape: a noise draw takes each element's sample from its own
    generator (:meth:`randn`), and splitting splits each generator, so the
    batch draws exactly what a loop over its elements would."""

    __slots__ = ("generators",)

    def __init__(self, generators: List[torch.Generator]) -> None:
        self.generators = list(generators)

    def __len__(self) -> int:
        return len(self.generators)

    def __getitem__(self, rows) -> Union[torch.Generator, "GeneratorBatch"]:
        picked = self.generators[rows]
        return GeneratorBatch(picked) if isinstance(rows, slice) else picked

    def randn(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """``(len, *shape)``: row i drawn on generator i, on the CPU."""
        return torch.stack([torch.randn(shape, generator=g, dtype=dtype, device=g.device)
                            .cpu() for g in self.generators])


def safe_random_split(
    generator, num: int = 2, device=None
) -> Union[Tuple[None, ...], Tuple[torch.Generator, ...], Tuple[GeneratorBatch, ...]]:
    """Derive *num* independent generators from *generator*.

    Each child is seeded with one 63-bit draw of the parent, so the parent
    advances and the children do not share its stream.  The children live
    on *device* (the CPU by default; a draw on the card needs a generator
    there).  ``None`` flows through as a tuple of ``None`` (noise-free
    circuits never draw); a :class:`GeneratorBatch` splits element by
    element into *num* batches.
    """
    if generator is None:
        return (None,) * num
    if isinstance(generator, GeneratorBatch):
        kids = [safe_random_split(g, num, device) for g in generator.generators]
        return tuple(GeneratorBatch([k[j] for k in kids]) for j in range(num))
    seeds = torch.randint(
        0, 2**63 - 1, (num,), generator=generator, dtype=torch.int64,
        device=generator.device,
    ).tolist()
    return tuple(
        torch.Generator(device=device or "cpu").manual_seed(int(s)) for s in seeds
    )


def __getattr__(name):
    # Lazy re-export to avoid a circular import at package-init time.
    if name == "PauliCircuit":
        from qml_essentials_tpu_torch.analysis.pauli import PauliCircuit

        return PauliCircuit
    raise AttributeError(name)
