"""Adaptive checkpointing (paper section 5.3, Table 2, Eq. 1/3/4).

Per SkipBlock i the controller tracks n_i (executions), k_i (materialized
checkpoints), and EMAs of C_i (block compute time) and M_i (materialization
time). A checkpoint is materialized only while the Joint Invariant holds:

    M_i / C_i  <  n_i / (k_i + 1) * min(1 / (1 + c), epsilon)      (Eq. 4)

which simultaneously enforces the Record Overhead invariant (Eq. 1: total
materialization time <= epsilon * total compute) and the Replay Latency
invariant (Eq. 3: record+replay never slower than two vanilla runs, for any
parallelism G >= 2). The restore/materialize ratio c starts at the paper's
naive 1.0 and is refined online from observed restores (paper: measured
average c = 1.38 across workloads).

Logging shares the budget: epsilon bounds TOTAL record overhead, and the
background log writer (repro_torch.logging) reports its serialize+spill+write
wall time here via ``observe_logging``. The epsilon the Joint Invariant
tests against is the RESIDUAL after observed logging cost — a
logging-heavy run materializes fewer checkpoints rather than silently
blowing the user's overhead bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.utils.timing import EMA


@dataclass
class BlockStats:
    n: int = 0                  # executions so far
    k: int = 0                  # checkpoints materialized so far
    C: EMA = field(default_factory=lambda: EMA(0.7))   # compute time
    M: EMA = field(default_factory=lambda: EMA(0.7))   # materialization time
    # transferred/logical bytes per checkpoint: with the delta pipeline a
    # mostly-frozen state transfers a small fraction of its nbytes, and the
    # pre-measurement M estimate must reflect that (honest M_i)
    tfrac: EMA = field(default_factory=lambda: EMA(0.7))
    pending: int = 0            # submitted but not yet measured


# default M estimate before we've ever materialized: bytes / ~1 GB/s
DEFAULT_WRITE_BPS = 1e9


class AdaptiveController:
    def __init__(self, epsilon: float = 1.0 / 15, c: float = 1.0,
                 enabled: bool = True, write_bps: float = DEFAULT_WRITE_BPS):
        self.epsilon = epsilon
        self.c = EMA(0.7)
        self.c.update(c)
        self.enabled = enabled
        # calibrated store throughput: the M estimate used BEFORE the first
        # materialization of a block (a bad default here lets the bootstrap
        # checkpoint blow the eps budget on short-epoch workloads)
        self.write_bps = write_bps
        self.blocks: dict[str, BlockStats] = {}
        # observed background-logging cost (repro_torch.logging reports every
        # flush): draws down the same epsilon budget as materialization
        self.log_s = 0.0
        self.log_bytes = 0
        # writer-thread time spent finalizing overlapped checkpoints (mask
        # sync + gather + encode). NOT charged against epsilon — overlap mode
        # exists precisely to move that work off the step path — but tracked
        # so the snapshot shows where the machine's time went
        self.bg_s = 0.0

    def _b(self, block_id: str) -> BlockStats:
        return self.blocks.setdefault(block_id, BlockStats())

    # ----------------------------------------------------------- logging --
    def observe_logging(self, seconds: float, nbytes: int = 0):
        """Account one log serialize/spill/write batch (thread-safe enough:
        float += races only smudge an EMA-free accumulator by one sample)."""
        self.log_s += float(seconds)
        self.log_bytes += int(nbytes)

    def _total_compute_s(self) -> float:
        return sum(b.n * b.C.value for b in self.blocks.values())

    def effective_epsilon(self) -> float:
        """The overhead budget LEFT for checkpoint materialization once
        observed logging cost is charged against epsilon (never negative —
        at/over budget, checkpointing pauses until compute catches up)."""
        total = self._total_compute_s()
        if not total or not self.log_s:
            return self.epsilon
        return max(self.epsilon - self.log_s / total, 0.0)

    # ------------------------------------------------------------ record --
    def observe_execution(self, block_id: str, compute_s: float):
        b = self._b(block_id)
        b.n += 1
        b.C.update(compute_s)

    def should_materialize(self, block_id: str, est_bytes: int = 0) -> bool:
        """Joint Invariant test (run after execution, before materialization:
        hence k_i + 1)."""
        if not self.enabled:
            return True
        b = self._b(block_id)
        C = b.C.value
        if C <= 0:
            return True
        if b.M.count:
            M = b.M.value
        else:
            # scale the logical size by the observed delta-transfer fraction
            # (1.0 until the pipeline has reported one)
            frac = b.tfrac.value if b.tfrac.count else 1.0
            M = est_bytes * frac / self.write_bps
        k_eff = b.k + b.pending
        thr = (b.n / (k_eff + 1)) * min(1.0 / (1.0 + self.c.value),
                                        self.effective_epsilon())
        return (M / C) < thr

    def observe_materialization(self, block_id: str, materialize_s: float):
        b = self._b(block_id)
        b.k += 1
        b.pending = max(0, b.pending - 1)
        b.M.update(materialize_s)

    def note_transfer(self, block_id: str, transferred_bytes: int,
                      logical_bytes: int):
        """Called at SUBMIT time (the fraction is known before the write
        stage finishes), so the pre-measurement M estimate of a block whose
        first materialization is still pending already reflects delta
        savings."""
        if logical_bytes:
            self._b(block_id).tfrac.update(transferred_bytes / logical_bytes)

    def note_submitted(self, block_id: str):
        self._b(block_id).pending += 1

    def note_background(self, seconds: float):
        """Account writer-thread work that overlap mode moved OFF the step
        path (fused-pass finalize: mask sync + gather + encode). Kept out of
        M_i / epsilon by design; visible in the snapshot."""
        self.bg_s += float(seconds)

    # ------------------------------------------------------------ replay --
    def observe_restore(self, block_id: str, restore_s: float):
        b = self._b(block_id)
        if b.M.count and b.M.value > 0:
            self.c.update(restore_s / b.M.value)

    # --------------------------------------------------------- invariants --
    def record_overhead_bound_ok(self, block_id: str) -> bool:
        """Eq. 1 check: k_i * M_i < n_i * eps * C_i (used by tests)."""
        b = self._b(block_id)
        if not b.n or not b.C.value:
            return True
        return b.k * b.M.value <= b.n * self.epsilon * b.C.value * 1.001

    def snapshot(self) -> dict:
        return {
            "epsilon": self.epsilon,
            "epsilon_effective": self.effective_epsilon(),
            "log_s": self.log_s,
            "log_bytes": self.log_bytes,
            "bg_s": self.bg_s,
            "c": self.c.value,
            "write_bps": self.write_bps,
            "blocks": {
                bid: {"n": b.n, "k": b.k, "C": b.C.value, "M": b.M.value,
                      "transfer_frac": b.tfrac.value if b.tfrac.count else None}
                for bid, b in self.blocks.items()
            },
        }
