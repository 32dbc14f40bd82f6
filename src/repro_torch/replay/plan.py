"""ReplayPlan: the minimal re-execution that answers a logging query.

The paper's headline claim is hindsight replay "orders of magnitude faster
than restarting from scratch"; FlorDB (arXiv:2408.02498) and Multiversion
Hindsight Logging (arXiv:2310.07898) sharpen it into *query-driven* replay:
given the probe set (what the user wants logged), compute which main-loop
epochs must re-EXECUTE, which only need their checkpoint RESTORED, and what
each costs — then hand the segments to a scheduler instead of fanning out a
blind contiguous split.

Inputs crossed here:

* the probe set — explicit block names, ``"*"``, or ``"auto"`` (the paper's
  section-3.2 source-diff tier: diff the recorded script copy against the
  current file, map added lines to their innermost enclosing loop; see
  ``core/probes.py``). Inner-loop probes force logical re-execution of the
  epochs that RUN that block; outer-loop probes only need every epoch
  restore-visited;
* record-side metadata — store meta ``run`` (epoch list, main-loop name),
  ``block_profile`` (measured per-(block, epoch) execution seconds: the
  honest exec-cost input, which is how skew becomes visible to the
  scheduler), and the manifest keys themselves (which blocks have Loop End
  Checkpoints where);
* ``CheckpointStore.stats(per_key=True)`` — resolve-chain depth and
  directly-listed chunk counts per manifest: per-epoch resume cost is
  wildly non-uniform under delta chains (depth 1 vs K), and the estimates
  here make that visible to LPT partitioning.

A plan's per-worker **visit list** ``[(epoch, "init"|"exec"), ...]`` is what
``core/generator.epoch_iter`` actually iterates (``ReplaySpec(segments=)``):
init visits restore (or logically redo) state continuity per the strong /
weak init mode; exec visits run the epoch with the probed blocks executing.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Iterable, Optional, Union

from repro_torch.core.probes import ProbeReport, detect_probes

PLAN_FILE = "replay.plan.json"

# cost-model constants: per parent-hop manifest resolution overhead, the
# fallback store read throughput / exec time when nothing was measured, and
# a nominal on-disk chunk size (the delta pipeline writes 64 KiB native
# chunks; compression varies but only RELATIVE segment cost matters to LPT,
# and a fixed figure avoids an O(store) objects-pool walk at plan time)
RESTORE_HOP_S = 0.002
DEFAULT_READ_BPS = 1e9
DEFAULT_EXEC_S = 1.0
NOMINAL_CHUNK_BYTES = 64 * 1024
# per-encoding DECODE throughputs (bytes of decoded output per second):
# restoring a q8/q4 chunk pays a dequantize pass, an entropy-compressed
# ("+z") one an extra decompress+unshuffle. Nominal figures — as with
# NOMINAL_CHUNK_BYTES only RELATIVE segment cost matters to the planner,
# and the per-chunk counts come from the manifests' recorded encodings.
DECODE_BPS = {"q8": 1.5e9, "q4": 1.2e9}
ENTROPY_DECODE_BPS = 0.8e9


def _decode_cost_s(enc_counts: Optional[dict], avg_chunk: int) -> float:
    """Extra restore seconds a key's encoded chunks cost to decode, from
    the per-encoding chunk counts the store's stats report. An entropy
    suffix ("+z") prices the decompress pass on top of the dequantize."""
    cost = 0.0
    for e, n in (enc_counts or {}).items():
        base = e[:-2] if e.endswith("+z") else e
        if base in DECODE_BPS:
            cost += n * avg_chunk / DECODE_BPS[base]
        if e.endswith("+z"):
            cost += n * avg_chunk / ENTROPY_DECODE_BPS
    return cost


class ReplayPlanError(RuntimeError):
    """The plan cannot be built from what the record run left behind."""


@dataclass(frozen=True)
class Segment:
    """One main-loop epoch in the plan."""
    epoch: int
    action: str                      # "exec" | "restore"
    exec_blocks: tuple = ()          # blocks that will re-execute logically
    exec_cost_s: float = 0.0         # estimated re-execution seconds
    restore_cost_s: float = 0.0      # estimated physical-restore seconds
    chain_depth: int = 0             # max delta-chain hops among its ckpts
    has_ckpt: bool = False           # any Loop End Checkpoint at this epoch
    hosts: int = 1                   # store shards its restores touch

    @property
    def cost(self) -> float:
        return self.exec_cost_s + self.restore_cost_s


@dataclass
class ReplayPlan:
    run_dir: str
    epochs: list                      # main-loop epoch values, in order
    probed: frozenset                 # inner blocks re-executing logically
    init_mode: str                    # strong | weak
    outer_probe: bool                 # outer-loop probes: visit every epoch
    main_loop: Optional[str]
    segments: list                    # [Segment, ...] one per epoch
    probe_source: dict = field(default_factory=dict)   # how probes resolved
    mesh: dict = field(default_factory=dict)   # recorded mesh meta, if any
    incomplete: list = field(default_factory=list)  # dist ckpts never stitched

    # ------------------------------------------------------------ queries --
    def segment(self, epoch) -> Segment:
        return self._by_epoch()[epoch]

    def _by_epoch(self) -> dict:
        return {s.epoch: s for s in self.segments}

    def exec_segments(self) -> list:
        return [s for s in self.segments if s.action == "exec"]

    def work_segments(self) -> list:
        """The segments workers are ASSIGNED (scheduled as work, visited in
        exec phase). Inner probes: only the epochs whose probed blocks
        actually run. Outer probes (or no probes at all): every epoch — the
        restore sweep itself is the work, and it parallelizes too."""
        ex = self.exec_segments()
        if self.outer_probe or not ex:
            return list(self.segments)
        return ex

    def visits_for(self, work: Optional[Iterable[Segment]] = None) -> list:
        """The ordered visit list for ONE worker assigned `work` (default:
        the whole plan): each work segment in epoch order preceded by the
        init visits that give it state continuity — every uncovered earlier
        epoch under strong init, only the nearest-checkpoint suffix under
        weak init. Returns ``[(epoch, "init"|"exec"), ...]``."""
        work = list(self.work_segments() if work is None else work)
        pos = {s.epoch: i for i, s in enumerate(self.segments)}
        work.sort(key=lambda s: pos[s.epoch])
        visits: list = []
        covered = -1
        for seg in work:
            i = pos[seg.epoch]
            if i <= covered:
                continue
            gap = self.segments[covered + 1:i]
            if self.init_mode == "weak" and gap:
                anchors = [g for g in gap if g.has_ckpt]
                if anchors:
                    gap = self.segments[pos[anchors[-1].epoch]:i]
            visits += [(g.epoch, "init") for g in gap]
            visits.append((seg.epoch, "exec"))
            covered = i
        return visits

    def summary(self) -> str:
        ex = self.exec_segments()
        n = len(self.segments)
        cost = sum(s.cost for s in self.work_segments())
        probes = ",".join(sorted(self.probed)) or "-"
        return (f"plan: {len(ex)}/{n} epochs re-execute "
                f"(probed: {probes}{', +outer' if self.outer_probe else ''}"
                f"), {self.init_mode} init, est work "
                f"{cost:.2f}s, max resume chain "
                f"{max((s.chain_depth for s in self.segments), default=0)}")

    # ------------------------------------------------------ serialization --
    def to_dict(self) -> dict:
        d = asdict(self)
        d["probed"] = sorted(self.probed)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ReplayPlan":
        from dataclasses import fields as dc_fields
        seg_keys = {f.name for f in dc_fields(Segment)}
        d = dict(d)
        d["probed"] = frozenset(d.get("probed") or ())
        d["segments"] = [Segment(**{**{k: v for k, v in s.items()
                                       if k in seg_keys},
                                    "exec_blocks":
                                    tuple(s.get("exec_blocks") or ())})
                         for s in d.get("segments") or []]
        d.pop("assignments", None)
        known = {f.name for f in dc_fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: Optional[str] = None,
             assignments: Optional[dict] = None) -> str:
        """Persist the plan (plus the scheduler's worker assignments when
        given) to ``<run_dir>/replay.plan.json`` for the merge step and
        post-hoc inspection."""
        path = path or os.path.join(self.run_dir, PLAN_FILE)
        d = self.to_dict()
        if assignments is not None:
            d["assignments"] = assignments
        with open(path, "w") as f:
            json.dump(d, f, indent=1, default=str)
        return path

    @classmethod
    def load(cls, run_dir: str) -> "ReplayPlan":
        with open(os.path.join(run_dir, PLAN_FILE)) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------- helpers --
def open_run_store(run_dir: str):
    """(CheckpointStore bound to the run's namespace, flor.run.json meta) —
    follows a shared-store binding when the run recorded into one."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.lineage import read_run_meta
    meta = read_run_meta(run_dir)
    root = meta.get("store_root") or os.path.join(run_dir, "store")
    return CheckpointStore(root, run_id=meta.get("namespace")), meta


def _parse_ckpt_key(key: str):
    """Sanitized manifest name -> (block, epoch, occurrence) or None."""
    if "_at_" not in key:
        return None
    block, rest = key.rsplit("_at_", 1)
    try:
        e, i = rest.split(".", 1)
        return block, int(e), int(i)
    except ValueError:
        return None


def detect_probes_for_run(run_dir: str, current_src: Optional[str] = None,
                          store=None) -> ProbeReport:
    """The ``--probe auto`` tier: diff the source copy the record run stored
    against the current file (or an explicit `current_src` path) and map
    added lines to loops. Raises ReplayPlanError when the record run stored
    no source copy (pre-snapshot run dirs)."""
    if store is None:
        store, _ = open_run_store(run_dir)
    src_meta = store.get_meta("source")
    if not src_meta or not src_meta.get("src"):
        raise ReplayPlanError(
            f"run {run_dir!r} stored no source copy; --probe auto needs one "
            f"(record with a current build, or pass probes explicitly)")
    cur_path = current_src or src_meta.get("path")
    if not cur_path or not os.path.isfile(cur_path):
        raise ReplayPlanError(
            f"current source {cur_path!r} not found; pass --current-src")
    with open(cur_path) as f:
        return detect_probes(src_meta["src"], f.read())


# ------------------------------------------------------------- build_plan --
def build_plan(run_dir: str,
               probed: Union[str, Iterable[str], None] = frozenset(),
               *, init_mode: str = "strong",
               epochs: Optional[Iterable] = None,
               current_src: Optional[str] = None,
               outer_probe: Optional[bool] = None,
               store=None) -> ReplayPlan:
    """Compute a ReplayPlan for `run_dir`.

    `probed`: an iterable of block names, ``"*"`` (all blocks), or
    ``"auto"`` (source-diff detection against the recorded script copy;
    `current_src` overrides the file to diff against). `epochs` falls back
    to the record run's stored epoch list. `outer_probe` forces (or
    suppresses) the visit-every-epoch restore sweep; by default it is
    inferred: on for auto-detected outer probes and for an empty probe set,
    off otherwise."""
    if init_mode not in ("strong", "weak"):
        raise ValueError(f"init_mode must be 'strong' or 'weak', "
                         f"got {init_mode!r}")
    if store is None:
        store, _ = open_run_store(run_dir)

    probe_source: dict = {"tier": "explicit"}
    report: Optional[ProbeReport] = None
    if isinstance(probed, str) and probed == "auto":
        report = detect_probes_for_run(run_dir, current_src=current_src,
                                       store=store)
        probed = set(report.probed_blocks)
        probe_source = {"tier": "source-diff",
                        "added_lines": len(report.added_lines),
                        "suspicious": len(report.suspicious),
                        "outer": sorted(report.probed_outer)}
    elif isinstance(probed, str):
        probed = {p for p in probed.split(",") if p}
    probed = set(probed or ())

    run_meta = store.get_meta("run") or {}
    if epochs is not None:
        epochs = list(epochs)
    elif run_meta.get("epochs") and all(e is not None
                                        for e in run_meta["epochs"]):
        epochs = list(run_meta["epochs"])
    elif run_meta.get("num_epochs") is not None:
        epochs = list(range(int(run_meta["num_epochs"])))
    else:
        raise ReplayPlanError(
            f"run {run_dir!r} has no recorded epoch list; pass epochs=")
    main_loop = run_meta.get("main_loop")

    # which blocks ran (and for how long) in which epochs: measured profile
    # first, checkpoint keys as the fallback for pre-profile run dirs
    profile = (store.get_meta("block_profile") or {}).get("blocks", {})
    occurrences: dict[str, dict[int, float]] = {}
    for bid, per_epoch in profile.items():
        for e, cell in per_epoch.items():
            occurrences.setdefault(bid, {})[int(e)] = float(cell.get("s", 0))
    # checkpoints a distributed record marked incomplete (a host died or
    # straggled past the stitch deadline): their v4 was never written —
    # usually they are already invisible to the listing, but a key the lead
    # flagged must never anchor a restore even if a partial artifact exists.
    # Meta records raw keys; list_keys() returns sanitized names — compare
    # in sanitized space.
    from repro_torch.checkpoint.store import _safe
    incomplete = {_safe(k) for k in
                  (store.get_meta("incomplete_ckpts") or {})
                  .get("keys") or ()}
    keys_by_epoch: dict[int, list[str]] = {}
    blocks_by_epoch: dict[int, set] = {}
    for k in store.list_keys():
        if k in incomplete:
            continue
        parsed = _parse_ckpt_key(k)
        if parsed is None:
            continue
        bid, e, _i = parsed
        keys_by_epoch.setdefault(e, []).append(k)
        blocks_by_epoch.setdefault(e, set()).add(bid)
        if bid not in occurrences or e not in occurrences[bid]:
            occurrences.setdefault(bid, {}).setdefault(e, 0.0)
    if not occurrences:
        raise ReplayPlanError(
            f"run {run_dir!r} has neither a block profile nor checkpoint "
            f"keys — nothing to plan over (did record finish?)")

    all_blocks = sorted(occurrences)
    if "*" in probed:
        probed = set(all_blocks)
    unknown = probed - set(all_blocks) - ({main_loop} if main_loop else set())
    if unknown:
        # either outer-loop ids or TYPOS: fall back to a full restore sweep
        # so the replay still visits everything, but say so loudly — a
        # misspelled probe silently re-executing nothing would look like a
        # vacuously passing replay
        import warnings
        warnings.warn(
            f"probed block(s) {sorted(unknown)} never ran in the record "
            f"run (known blocks: {all_blocks}"
            + (f", main loop: {main_loop!r}" if main_loop else "")
            + "); treating them as outer probes — no epoch will re-execute "
            "for them", stacklevel=2)
    # probed names the record run never saw are either outer-loop ids or
    # typos; treat them as outer so the user still gets a full restore sweep
    if outer_probe is None:
        outer_probe = (not probed) or bool(unknown) \
            or (main_loop is not None and main_loop in probed) \
            or bool(report and report.probed_outer)
    probed &= set(all_blocks)
    if unknown:
        probe_source = dict(probe_source, unknown=sorted(unknown))

    # exec-cost fallback: the median measured epoch-execution time
    measured = [s for per in occurrences.values() for s in per.values()
                if s > 0]
    fallback_exec = sorted(measured)[len(measured) // 2] if measured \
        else DEFAULT_EXEC_S

    # resume-cost raw material: one memoized per-key stats pass (manifests
    # only — include_chunks would walk the whole shared objects pool)
    all_keys = [k for ks in keys_by_epoch.values() for k in ks]
    st = store.stats(keys=all_keys, include_chunks=False, per_key=True) \
        if all_keys else {"per_key": {}}
    per_key = st.get("per_key", {})
    avg_chunk = NOMINAL_CHUNK_BYTES
    # learned restore cost model: measured read throughput and per-hop
    # latency (fit from observed restores in FlorContext.finish, seeded by
    # the calibration probe's read-back). Older stores only recorded
    # write_bps — use it as a same-medium proxy before falling back to the
    # constants.
    calib = store.get_meta("store_calib") or {}
    read_bps = float(calib.get("read_bps") or calib.get("write_bps")
                     or DEFAULT_READ_BPS)
    hop_s = float(calib["hop_s"]) if calib.get("hop_s") is not None \
        else RESTORE_HOP_S
    # per-store-shard service rates (learned from sharded restores or a
    # calibration probe); absent shards fall back to the global figure
    shard_bps = {str(k): float(v)
                 for k, v in (calib.get("shard_read_bps") or {}).items()
                 if v}

    segments = []
    for e in epochs:
        try:
            ei = int(e)
        except (TypeError, ValueError):
            raise ReplayPlanError(
                f"planned replay needs integer epoch values, got {e!r}")
        here = {b for b, per in occurrences.items() if ei in per}
        if not here:
            # an epoch with NO evidence at all (no profile — e.g. the record
            # crashed before finish() persisted it — and no checkpoint under
            # adaptive sparsity): assume every known block runs there, the
            # legacy re-execute-everything semantics. Skipping it instead
            # would silently drop the probe's rows for that epoch while the
            # deferred check still passed.
            here = set(all_blocks)
        exec_blocks = tuple(sorted(here & probed))
        ckpt_blocks = blocks_by_epoch.get(ei, set())
        # blocks that ran but left no checkpoint re-execute regardless of
        # the probe set (logical redo is the only way to pass through them)
        forced = {b for b in here - set(exec_blocks) if b not in ckpt_blocks}
        exec_cost = sum(occurrences[b].get(ei) or fallback_exec
                        for b in set(exec_blocks) | forced)
        restore_cost = 0.0
        depth = 0
        hosts_touched: set = set()
        for k in keys_by_epoch.get(ei, []):
            parsed = _parse_ckpt_key(k)
            if parsed and parsed[0] in exec_blocks:
                continue          # re-executing blocks don't restore
            info = per_key.get(k) or {}
            shards = info.get("shards") or {}
            if shards:
                # sharded manifest: hosts read their store shards
                # concurrently, so the wall-clock restore is the MAX over
                # hosts of local bytes / that shard's service rate — not the
                # aggregate-bytes figure the flat model would charge
                d_k = max(int(s.get("depth") or 0) for s in shards.values())
                depth = max(depth, d_k)
                restore_cost += hop_s * (1 + d_k)
                restore_cost += max(
                    int(s.get("chunks") or 0) * avg_chunk
                    / (shard_bps.get(str(hid)) or read_bps)
                    for hid, s in shards.items())
                hosts_touched.update(str(hid) for hid in shards)
            else:
                depth = max(depth, int(info.get("depth") or 0))
                restore_cost += hop_s * (1 + int(info.get("depth") or 0))
                restore_cost += int(info.get("direct_chunks") or 0) \
                    * avg_chunk / read_bps
            # encoded chunks (q8/q4, entropy-compressed) pay a decode pass
            # on top of the raw read — priced from the manifests' recorded
            # per-chunk encodings
            restore_cost += _decode_cost_s(info.get("enc_counts"),
                                           avg_chunk)
        segments.append(Segment(
            epoch=ei, action="exec" if exec_blocks else "restore",
            exec_blocks=exec_blocks, exec_cost_s=exec_cost,
            restore_cost_s=restore_cost, chain_depth=depth,
            has_ckpt=bool(ckpt_blocks), hosts=max(1, len(hosts_touched))))

    return ReplayPlan(run_dir=run_dir, epochs=[s.epoch for s in segments],
                      probed=frozenset(probed), init_mode=init_mode,
                      outer_probe=bool(outer_probe), main_loop=main_loop,
                      segments=segments, probe_source=probe_source,
                      mesh=dict(store.get_meta("mesh") or {}),
                      incomplete=sorted(incomplete))
