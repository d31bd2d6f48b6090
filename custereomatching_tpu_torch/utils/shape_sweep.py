"""Seeded random shapes for holding the port to its references.

The counterpart of the case draw of the JAX package's randomized-shape
sweep (``tests/test_fuzz_shapes.py``): fixed shape lists miss margins, so
a seeded generator draws ``(B, H, W, D, k)`` cases, the same ones every
run.  Two groups:

* the JAX sweep's own space: H in [9, 40), W in [17, 70), k in {3, 5, 7,
  9, 15}, D in [0, min(W - 1, 24)), one frame;
* the margins the plain op takes and fixed shapes miss: D >= W (up to
  W + 8) and D = 0, H < k, all-pairs with k // 2 > W (W in [2, 9], k in
  [9, 31]), batches of 2 and 3, and k = 1 (banded and all-pairs).

It imports only numpy, so ``tests/test_torch_fuzz_shapes.py`` (the port
against the JAX package on the CPU) and ``chip_smoke.py``'s ``fuzz``
phase (every kernel against its plain version on the card) draw the same
cases.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

SEED = 20261018
JAX_SPACE_CASES = 6


class SweepCase(NamedTuple):
    """One drawn case: ``D`` None is the all-pairs volume; ``seed`` draws
    its images and cotangents; ``tag`` names the margin it covers."""

    B: int
    H: int
    W: int
    D: Optional[int]
    k: int
    seed: int
    tag: str

    @property
    def planes(self) -> int:
        """The volume's last extent: W (all-pairs) or D + 1."""
        return self.W if self.D is None else self.D + 1

    def __str__(self) -> str:
        mode = "ap" if self.D is None else f"D{self.D}"
        return (f"{self.tag}-B{self.B}-H{self.H}-W{self.W}-{mode}-k{self.k}")


def _odd(rng: np.random.Generator, lo: int, hi: int) -> int:
    """An odd integer in [lo, hi] (lo odd)."""
    return lo + 2 * int(rng.integers(0, (hi - lo) // 2 + 1))


def sweep_cases() -> List[SweepCase]:
    """The sweep's cases, drawn from ``np.random.default_rng(SEED)``: the
    same ones on every call, so the CPU test and the card phase pair."""
    rng = np.random.default_rng(SEED)
    cases = []

    def add(B, H, W, D, k, tag):
        cases.append(SweepCase(int(B), int(H), int(W),
                               None if D is None else int(D), int(k),
                               int(rng.integers(0, 2**31)), tag))

    for _ in range(JAX_SPACE_CASES):
        H = rng.integers(9, 40)
        W = rng.integers(17, 70)
        k = rng.choice([3, 5, 7, 9, 15])
        add(1, H, W, rng.integers(0, min(W - 1, 24)), k, "jax")
    for B in (1, 2):                                   # D >= W
        W = rng.integers(5, 20)
        add(B, rng.integers(9, 24), W, W + rng.integers(0, 9),
            rng.choice([3, 5, 7, 9]), "dgew")
    add(3, rng.integers(9, 24), rng.integers(17, 40), 0,      # D = 0
        rng.choice([3, 5, 7]), "d0")
    k = rng.choice([15, 21, 25])                              # H < k
    add(1, rng.integers(2, k), rng.integers(17, 50), rng.integers(0, 16), k,
        "hltk")
    k = rng.choice([9, 15])
    add(1, rng.integers(2, k), rng.integers(10, 30), None, k, "hltk")
    for B, D in ((1, None), (2, None), (1, None), (1, "band")):
        W = int(rng.integers(2, 10))                      # k // 2 > W
        k = _odd(rng, max(9, 2 * W + 3), 31)
        add(B, rng.integers(3, 20), W, rng.integers(0, 2 * W + 1)
            if D == "band" else None, k, "pgtw")
    add(2, rng.integers(9, 24), rng.integers(17, 40), None,   # all-pairs
        rng.choice([3, 5, 7, 9, 15]), "ap")
    add(1, rng.integers(5, 20), rng.integers(8, 30), rng.integers(0, 11), 1,
        "k1")
    add(1, rng.integers(5, 20), rng.integers(8, 30), None, 1, "k1")
    return cases


def case_pair(case: SweepCase) -> Tuple[np.ndarray, np.ndarray]:
    """The case's ``[B, H, W]`` camera and projector, uniform in [0, 1)."""
    rng = np.random.default_rng(case.seed)
    shape = (case.B, case.H, case.W)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


def case_cotangent(case: SweepCase) -> np.ndarray:
    """A standard normal ``[B, H, W, L]`` volume cotangent for the case."""
    rng = np.random.default_rng(case.seed + 1)
    return rng.standard_normal(
        (case.B, case.H, case.W, case.planes)).astype(np.float32)


__all__ = ["SweepCase", "case_cotangent", "case_pair",
           "sweep_cases"]
