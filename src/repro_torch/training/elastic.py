"""Elastic scaling + straggler mitigation: the port's copy of the JAX
package's ``training/elastic.py`` (pure Python).

On a real fleet these hooks are driven by the cluster scheduler; here they
are pure functions so the policy is testable:

* ``replan_mesh``     — choose a new (data, model) mesh after node loss,
  keeping TP intact (model axis must stay whole — it holds sharded weights)
  and shrinking/growing the data axis. Re-entry = checkpoint restore on the
  new mesh.
* ``StragglerPolicy`` — per-step host heartbeats → skip/rebalance decision.
  With the deterministic sharded data pipeline (``repro_torch.data``),
  dropping or reassigning a shard needs no data movement: any host can
  regenerate any shard from (seed, step, shard).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pod: int = 1

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pod


def replan_mesh(plan: MeshPlan, healthy_devices: int,
                global_batch: int) -> MeshPlan:
    """Largest data axis that fits healthy devices with TP (model) intact.

    Keeps data a divisor of global_batch so batches reshard cleanly.
    """
    assert healthy_devices >= plan.model, "cannot keep TP group alive"
    max_data = healthy_devices // (plan.model * plan.pod)
    data = max_data
    while data > 1 and global_batch % data != 0:
        data -= 1
    return MeshPlan(data=max(data, 1), model=plan.model, pod=plan.pod)


@dataclass
class StragglerPolicy:
    """Skip-slow-replica policy over per-host step latencies (EWMA)."""
    threshold: float = 2.0          # × median EWMA ⇒ straggler
    alpha: float = 0.3
    ewma: dict = field(default_factory=dict)

    def observe(self, host: str, step_seconds: float) -> None:
        prev = self.ewma.get(host, step_seconds)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_seconds

    def stragglers(self) -> list[str]:
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        return [h for h, v in self.ewma.items() if v > self.threshold * median]

    def reassign_shards(self, num_shards: int, hosts: list[str]) -> dict:
        """Shard→host map excluding stragglers (deterministic round-robin).
        Because batches are pure functions of (seed, step, shard), the new
        owner resumes mid-epoch with zero data movement."""
        bad = set(self.stragglers())
        good = [h for h in hosts if h not in bad] or hosts
        return {s: good[s % len(good)] for s in range(num_shards)}
