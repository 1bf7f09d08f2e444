"""Card placement for launchers that start one JAX process per role.

A JAX process reserves three quarters of a GPU's memory when it first
uses the card, so a second process on the same card fails for want of
memory.  The job runner (runtime/job.py) and the local cluster runner
(runtime/cluster.py) therefore give their children cards by one rule:

- while there are at least as many visible cards as children, each child
  sees one card of its own (CUDA_VISIBLE_DEVICES);
- otherwise children are dealt round-robin onto the cards and each gets
  an explicit XLA_PYTHON_CLIENT_MEM_FRACTION share of its card;
- children forced onto the CPU, or a machine without cards, keep the
  parent's environment.

The parent decides without initialising JAX: it must stay off the card.
"""

from __future__ import annotations

import math
import subprocess
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = ["visible_cards", "child_envs"]

# share of a card left to XLA across the processes on it; the rest covers
# each process's CUDA context and the cuBLAS/cuDNN workspaces
_CARD_SHARE = 0.8


def visible_cards(env: Mapping[str, str]) -> List[str]:
    """Card ids children may use, as CUDA_VISIBLE_DEVICES spells them."""
    if env.get("FLASHE_FORCE_CPU") or env.get("JAX_PLATFORMS") == "cpu":
        return []
    if "CUDA_VISIBLE_DEVICES" in env:
        return [c.strip() for c in env["CUDA_VISIBLE_DEVICES"].split(",")
                if c.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [str(i) for i, line in enumerate(
        l for l in out.splitlines() if l.startswith("GPU "))]


def child_envs(base: Mapping[str, str], n_children: int,
               cards: Optional[List[str]] = None
               ) -> Tuple[List[Dict[str, str]], str]:
    """Per-child environments and a one-line description of the rule."""
    cards = visible_cards(base) if cards is None else list(cards)
    envs = [dict(base) for _ in range(n_children)]
    if not cards:
        return envs, "no GPU for the role processes: they run on the CPU"
    if len(cards) >= n_children:
        for env, card in zip(envs, cards):
            env["CUDA_VISIBLE_DEVICES"] = card
        return envs, (f"one card per process: {n_children} processes on "
                      f"{n_children} of {len(cards)} cards")
    per_card = math.ceil(n_children / len(cards))
    frac = f"{math.floor(1000 * _CARD_SHARE / per_card) / 1000:.3f}"
    for i, env in enumerate(envs):
        env["CUDA_VISIBLE_DEVICES"] = cards[i % len(cards)]
        env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = frac
    return envs, (f"{n_children} processes share {len(cards)} card(s), "
                  f"up to {per_card} per card: "
                  f"XLA_PYTHON_CLIENT_MEM_FRACTION={frac} each")
