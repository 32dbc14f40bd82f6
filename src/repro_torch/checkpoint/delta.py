"""Device-side delta detection for lean checkpointing.

The host-side content-addressed store already avoids STORING unchanged
chunks; this layer avoids TRANSFERRING them. Per leaf it keeps the previous
checkpoint's per-chunk digests on the leaf's device; at checkpoint time the
fingerprint kernel (kernels/chunk_delta.py) produces new digests in one read
of the leaf, and only rows with changed digests are gathered and copied to
host. On fine-tuning-shaped workloads (frozen experts/embeddings) this cuts
device->host traffic by the frozen fraction — the same economics as the
paper's lean checkpointing, one level lower.

`CheckpointPipeline` (checkpoint/pipeline.py) is the consumer: it turns the
gathered word blocks back into native leaf bytes (`blocks_to_native_bytes`)
and hands them to the writer stage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import (CHUNK_WORDS, chunk_absmax,
                                     fingerprint_and_changed,
                                     fingerprint_leaf, gather_changed_blocks,
                                     gather_quantize4_blocks,
                                     gather_quantize_blocks,
                                     native_bytes_per_word)

# Error-bound encoding selector thresholds. The TRUE per-element bound of a
# blockwise codec is half a quantization step: absmax/254 for q8 (scale =
# absmax/127), absmax/14 for q4 (scale = absmax/7). The selector divides by
# smaller figures so f32 scale rounding can never push a chunk past its
# declared atol — the bound it GUARANTEES is absmax/Q8_ATOL_DIV (resp. q4).
Q8_ATOL_DIV = 126.0
Q4_ATOL_DIV = 13.5


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def blocks_to_native_bytes(blocks: np.ndarray, dtype) -> list[bytes]:
    """Convert gathered [C, W] u32 word blocks back to the original array's
    byte representation, one bytes object per chunk. Inverts the dtype
    widening of the word view (each word carries
    `native_bytes_per_word(dtype)` original bytes; padding words at the tail
    of the last chunk are zeros and are truncated by the caller)."""
    bpw = native_bytes_per_word(dtype)
    blocks = np.ascontiguousarray(blocks).view(np.uint32)
    if bpw == 4:
        rows = blocks
    elif bpw == 2:
        rows = blocks.astype(np.uint16)
    else:
        rows = blocks.astype(np.uint8)
    return [rows[i].tobytes() for i in range(rows.shape[0])]


def _grid_rows(nbytes: int, bpw: int, chunk_words: int) -> int:
    """Rows of the [G, chunk_words] block view a leaf of `nbytes` produces
    (G is padded to a multiple of 8)."""
    n = max(1, nbytes // bpw)
    g = -(-n // chunk_words)
    return -(-g // 8) * 8


class DeltaTracker:
    def __init__(self, chunk_words: int = CHUNK_WORDS):
        self.chunk_words = chunk_words
        self._digests: dict[str, torch.Tensor] = {}

    def delta_dispatch(self, path: str, leaf: torch.Tensor, *,
                       enc: str = "raw", error_bound: float = None) -> dict:
        """Phase 1 of a delta: launch the device work (fused fingerprint +
        changed-mask when a previous digest exists) WITHOUT any host sync,
        and update the stored digest to the new device tensor. Returns an
        opaque handle for :meth:`finalize`. The overlap-mode pipeline calls
        this on the training thread (launch-only cost) and finalizes on the
        writer thread; the synchronous path composes both in :meth:`delta`.

        Encoding selection: ``enc`` fixes the wire encoding of every changed
        chunk ("raw" | "q8" | "q4"). ``error_bound`` switches to the
        ADAPTIVE selector instead: a per-chunk absmax pass (``chunk_absmax``,
        one extra leaf read, launched here) lets finalize pick, per changed
        chunk, the cheapest encoding whose guaranteed bound satisfies the
        atol — q4 when absmax/13.5 <= atol, else q8 when absmax/126 <= atol,
        else raw. Float leaves only (the caller gates on quantizable_dtype).

        The handle keeps a reference to `leaf`. That is safe because the
        train step is functional: it returns new tensors and never writes a
        checkpointed one in place, so a deferred finalize gathers exactly the
        submitted bytes while training goes on. A caller that mutates a
        submitted tensor in place before finalize would gather post-mutation
        bytes."""
        if error_bound is not None:
            enc = "auto"
        nbytes = leaf.numel() * leaf.element_size()
        bpw = native_bytes_per_word(leaf.dtype)
        prev = self._digests.get(path)
        if prev is not None \
                and int(prev.shape[0]) == _grid_rows(nbytes, bpw,
                                                     self.chunk_words) \
                and prev.device == leaf.device:
            digest, mask = fingerprint_and_changed(leaf, prev,
                                                   self.chunk_words)
            first = False
        else:
            digest = fingerprint_leaf(leaf, self.chunk_words)
            mask = None
            first = True                              # first sight: all new
        self._digests[path] = digest
        absmax = chunk_absmax(leaf, self.chunk_words) if enc == "auto" \
            else None
        return {"path": path, "leaf": leaf, "digest": digest, "mask": mask,
                "first": first, "enc": enc, "error_bound": error_bound,
                "absmax": absmax, "nbytes": nbytes, "bpw": bpw}

    def _gather_group(self, h: dict, enc: str, idx: np.ndarray) -> dict:
        """Gather one encoding group's changed rows off the device. Returns
        {enc, idx, bytes, <wire arrays per encoding>}."""
        leaf = h["leaf"]
        tidx = torch.from_numpy(idx.astype(np.int32)).to(leaf.device)
        if enc == "q8":
            q, s = gather_quantize_blocks(leaf, tidx, self.chunk_words)
            q, s = _host(q), _host(s)
            return {"enc": "q8", "idx": idx, "q": q, "scales": s,
                    "bytes": int(q.nbytes + s.nbytes)}
        if enc == "q4":
            p, s = gather_quantize4_blocks(leaf, tidx, self.chunk_words)
            p, s = _host(p), _host(s)
            return {"enc": "q4", "idx": idx, "packed": p, "scales": s,
                    "bytes": int(p.nbytes + s.nbytes)}
        rows = _host(gather_changed_blocks(leaf, tidx, self.chunk_words))
        return {"enc": "raw", "idx": idx, "blocks": rows.view(np.uint32),
                "bytes": int(rows.nbytes)}

    def finalize(self, h: dict) -> dict:
        """Phase 2: sync the change mask, gather the changed rows in wire
        form per the handle's encoding (fixed raw/q8/q4, or the adaptive
        error-bound selector), and return the delta record. Touches no
        tracker state, so it is safe to run on the writer thread while the
        training thread keeps launching.

        Returns {digest (np uint32 [G, 2]), mask (np bool [G]), enc_groups
        ([{enc, idx, ...}] — one group per distinct wire encoding chosen),
        changed_idx, transferred_bytes, total_bytes}."""
        digest = h["digest"]
        g = int(digest.shape[0])
        if h["first"]:
            mask = np.ones((g,), bool)
        else:
            mask = _host(h["mask"]).astype(bool)
        nbytes, bpw = h["nbytes"], h["bpw"]
        n_real = max(1, -(-nbytes // (self.chunk_words * bpw)))
        idx = np.flatnonzero(mask[:n_real])
        enc = h["enc"]
        groups: list[dict] = []
        if idx.size:
            if enc == "auto":
                # per-chunk selector: the cheapest encoding whose GUARANTEED
                # bound (absmax / divisor) satisfies the slot's atol
                amax = _host(h["absmax"])[idx]
                atol = float(h["error_bound"])
                pick = np.where(
                    amax / Q4_ATOL_DIV <= atol, "q4",
                    np.where(amax / Q8_ATOL_DIV <= atol, "q8", "raw"))
                for e in ("q4", "q8", "raw"):
                    sub = idx[pick == e]
                    if sub.size:
                        groups.append(self._gather_group(h, e, sub))
            else:
                groups.append(self._gather_group(h, enc, idx))
        return {
            "digest": _host(digest).view(np.uint32),
            "mask": mask,
            "enc_groups": groups,
            "changed_idx": idx,
            "transferred_bytes": sum(gr["bytes"] for gr in groups),
            "total_bytes": int(g * self.chunk_words * 4),
        }

    def delta(self, path: str, leaf: torch.Tensor, *, enc: str = "raw",
              error_bound: float = None) -> dict:
        """Synchronous delta: dispatch + finalize in one call. Updates the
        stored digest — call exactly once per MATERIALIZED checkpoint so the
        mask always means "changed since the last stored checkpoint".

        Host traffic per call: the [G] change mask, the [G, 2] digest, and
        the changed rows. Rows past the leaf's real byte length are never
        gathered, and a fully-unchanged leaf costs ONLY the fused
        fingerprint read."""
        return self.finalize(self.delta_dispatch(path, leaf, enc=enc,
                                                 error_bound=error_bound))

    def forget(self, path: str):
        """Drop one leaf's digests — the next delta() transfers everything
        (used when a leaf's dtype changes without changing its block count,
        which the digest comparison alone cannot flag as a full rewrite)."""
        self._digests.pop(path, None)

    def reset(self):
        self._digests.clear()
