"""Adaptive τ for local SGD: the paper's knob, closed-loop.

Counterpart of ``sparknet_tpu/parallel/tau_controller.py`` (pure
Python, copied). SparkNet leaves τ a hand-set constant: more local
steps amortize communication but add staleness. With ``--tau auto``
the solver measures both sides per round, the share of the round's
wall time spent averaging on one side and the loss trajectory on the
other, and τ becomes a control loop:

- **Widen** (τ ← 2τ, up to ``tau_max``) when the round is *sync-bound*:
  the average takes more than ``widen_share`` of the round.
- **Narrow** (τ ← τ/2, down to ``tau_min``) when the loss *diverges*
  between syncs: a round's τ-mean loss more than ``narrow_divergence``
  above its smoothed trajectory.

τ moves by doubling and halving only. Every decision lands in the
decision log, which the apps print as a ``tau:`` line and write next to
the snapshots (``<prefix>_tau_controller.json``). The solver passes the
anomaly board's straggler advisories (``telemetry/anomaly.py``). The
JAX package's telemetry gauges and its layout advisories are not
ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


class TauController:
    """Host-side τ control loop for :class:`ParallelSolver` local mode.

    Call :meth:`observe_round` once per completed round with that
    round's wall seconds, its communication-phase seconds (exposed
    ``grad_allreduce`` + ``multihost_sync``, from the timeline), and
    the round's mean loss; it returns the τ to use for the NEXT round.
    """

    def __init__(
        self,
        tau: int = 8,
        tau_min: Optional[int] = None,
        tau_max: Optional[int] = None,
        widen_share: float = 0.25,
        narrow_divergence: float = 0.10,
        loss_smoothing: float = 0.7,
        cooldown_rounds: int = 2,
    ):
        self.tau_min = tau_min if tau_min is not None else _env_int(
            "SPARKNET_TAU_MIN", 1
        )
        self.tau_max = tau_max if tau_max is not None else _env_int(
            "SPARKNET_TAU_MAX", 64
        )
        if not (1 <= self.tau_min <= self.tau_max):
            raise ValueError(
                f"need 1 <= tau_min <= tau_max, got "
                f"[{self.tau_min}, {self.tau_max}]"
            )
        self.tau = int(min(max(tau, self.tau_min), self.tau_max))
        self.widen_share = widen_share
        self.narrow_divergence = narrow_divergence
        self.loss_smoothing = loss_smoothing
        # decisions need a few rounds of signal at the NEW tau before
        # moving again — without a cooldown one noisy loss round can
        # saw the controller between two values forever
        self.cooldown_rounds = max(0, cooldown_rounds)
        self._cooldown = 0
        self._loss_ema: Optional[float] = None
        self._round = 0
        self.decisions: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def observe_round(
        self, *, round_s: float, sync_s: float, loss: float,
        advisories=None,
    ) -> int:
        """Digest one round's telemetry; returns the next round's τ.

        ``advisories``: a list of ``{"kind": ...}`` dicts; while one of
        kind ``"straggler"`` is in it, every sync waits on the slow
        worker, so the widen threshold halves."""
        self._round += 1
        share = (sync_s / round_s) if round_s > 0 else 0.0
        straggler = any(
            a.get("kind") == "straggler" for a in (advisories or ())
        )
        widen_share = self.widen_share * (0.5 if straggler else 1.0)
        if self._loss_ema is None:
            self._loss_ema = loss
        divergence = (
            (loss - self._loss_ema) / max(abs(self._loss_ema), 1e-12)
        )
        prev_tau, action, why = self.tau, "hold", ""
        if self._cooldown > 0:
            self._cooldown -= 1
            why = "cooldown"
        elif divergence > self.narrow_divergence and self.tau > self.tau_min:
            # staleness is winning: halve toward fresher syncs
            self.tau = max(self.tau_min, self.tau // 2)
            action, why = "narrow", (
                f"divergence {divergence:.1%} > {self.narrow_divergence:.0%}"
            )
            self._cooldown = self.cooldown_rounds
        elif share > widen_share and self.tau < self.tau_max:
            # sync-bound: double the local work each round amortizes
            self.tau = min(self.tau_max, self.tau * 2)
            action, why = "widen", (
                f"sync share {share:.1%} > {widen_share:.0%}"
                + (" (straggler advisory active)" if straggler else "")
            )
            self._cooldown = self.cooldown_rounds
        # EMA after the divergence test: the test compares THIS round
        # against the trajectory before it
        self._loss_ema = (
            self.loss_smoothing * self._loss_ema
            + (1.0 - self.loss_smoothing) * loss
        )
        decision = {
            "round": self._round,
            "tau": prev_tau,
            "next_tau": self.tau,
            "action": action,
            "reason": why,
            "sync_share": round(share, 4),
            "divergence": round(divergence, 4),
            "round_s": round(round_s, 5),
            "sync_s": round(sync_s, 5),
            "loss": round(float(loss), 6),
        }
        if straggler:
            decision["straggler_advisory"] = True
        self.decisions.append(decision)
        return self.tau

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The machine-readable run record (the ``tau:`` log line and
        ``<prefix>_tau_controller.json``)."""
        taus = [d["next_tau"] for d in self.decisions]
        return {
            "tau": self.tau,
            "tau_min": self.tau_min,
            "tau_max": self.tau_max,
            "rounds": self._round,
            "widened": sum(1 for d in self.decisions if d["action"] == "widen"),
            "narrowed": sum(
                1 for d in self.decisions if d["action"] == "narrow"
            ),
            "tau_trajectory": taus,
            "decisions": self.decisions,
        }

    def json_line(self) -> str:
        return json.dumps(self.snapshot())

    def write_report(self, snapshot_prefix: str) -> Optional[str]:
        """Persist the decision record next to the run's snapshots
        (``<prefix>_tau_controller.json``); returns the path, or None
        when there is no prefix to anchor it to."""
        if not snapshot_prefix:
            return None
        path = f"{snapshot_prefix}_tau_controller.json"
        # best effort: the decision record is observability, not state,
        # and a full disk must not fail the training run
        try:
            with open(path, "w") as fh:
                json.dump(self.snapshot(), fh)
        except OSError:
            return None
        return path


def parse_tau(value) -> tuple:
    """App-side ``--tau`` parsing: an int, or ``auto`` for the
    controller.  Returns ``(tau_int_or_initial, auto: bool)``."""
    if isinstance(value, int):
        return value, False
    s = str(value).strip().lower()
    if s == "auto":
        return _env_int("SPARKNET_TAU_INITIAL", 8), True
    try:
        return int(s), False
    except ValueError:
        raise ValueError(
            f"--tau must be an integer or 'auto', got {value!r}"
        ) from None
