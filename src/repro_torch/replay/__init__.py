"""Query-driven hindsight replay: plan the minimal re-execution that
answers the logging query, then schedule it cost-balanced over workers.

    plan.py      — ReplayPlan: probe set (explicit or source-diff `auto`)
                   x checkpoint-manifest metadata -> per-epoch segments
                   annotated with resume-cost estimates
    scheduler.py — LPT cost-balanced partitioning + a dynamic work-queue
                   executor (straggler re-queue, incremental completion)

``launch/replay.py`` is a thin front end over these; tests and benchmarks use
them in-process.
"""
from repro_torch.replay.plan import (  # noqa: F401
    ReplayPlan, ReplayPlanError, Segment, build_plan, detect_probes_for_run,
    open_run_store)
from repro_torch.replay.scheduler import (  # noqa: F401
    DEFAULT_STRAGGLER_FACTOR, DynamicExecutor, Task, TaskFailure,
    assign_hosts, balanced_shares, contiguous_shares,
    measured_straggler_factor, share_cost)
