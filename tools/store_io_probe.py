#!/usr/bin/env python3
"""Time the checkpoint store's chunk writes and reads at several thread
counts, on the file system of this checkout.

    python3 tools/store_io_probe.py [--mb 128] [--threads 1,4,8,16]

Run from the root of a checkout. It writes ``--mb`` MiB of seeded f32
values (normal, scale 0.02, like a model's weights) as 64 KiB chunks into
a fresh ``CheckpointStore`` under ``build/store_io_probe`` through
``put_chunk`` (one thread) or ``put_chunks`` (``store.IO_THREADS`` set to
the count), reads them back through ``get_chunk`` / ``get_chunks``,
checks the bytes, and removes the store. Prints one line per thread count
with the put and get rates in MB/s, then the store's codec and blake2b
alone over the same chunks on one thread. Needs no card.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import store as store_mod  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.utils.codec import Compressor, have_zstd  # noqa: E402

CHUNK_VALUES = 16 * 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=128)
    ap.add_argument("--threads", default="1,4,8,16")
    args = ap.parse_args()
    values = np.random.default_rng(0).standard_normal(
        args.mb * 2**20 // 4).astype(np.float32) * np.float32(0.02)
    chunks = [values[i:i + CHUNK_VALUES].tobytes()
              for i in range(0, values.size, CHUNK_VALUES)]
    print(f"{len(chunks)} chunks of {CHUNK_VALUES * 4} bytes, "
          f"{os.cpu_count()} cores")
    base = os.path.join(ROOT, "build", "store_io_probe")
    for n in [int(x) for x in args.threads.split(",")]:
        shutil.rmtree(base, ignore_errors=True)
        st = CheckpointStore(base)
        store_mod.IO_THREADS = n
        t0 = time.perf_counter()
        if n == 1:
            put = [st.put_chunk(c) for c in chunks]
        else:
            put = st.put_chunks(chunks)
        t_put = time.perf_counter() - t0
        hashes = [h for h, _, _ in put]
        t0 = time.perf_counter()
        if n == 1:
            got = [st.get_chunk(h) for h in hashes]
        else:
            got = st.get_chunks(hashes)
        t_get = time.perf_counter() - t0
        if got != chunks:
            print(f"threads {n}: the chunks read back differ")
            return 1
        print(f"threads {n}: put {t_put:.3f} s ({args.mb / t_put:.1f} MB/s),"
              f" get {t_get:.3f} s ({args.mb / t_get:.1f} MB/s)")
    shutil.rmtree(base, ignore_errors=True)
    codec = Compressor(level=3)
    t0 = time.perf_counter()
    for c in chunks:
        codec.compress(c)
    t_z = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in chunks:
        hashlib.blake2b(c, digest_size=16).hexdigest()
    t_h = time.perf_counter() - t0
    name = "zstd" if have_zstd else "zlib"
    print(f"one thread, no files: {name}-3 {t_z:.3f} s, blake2b {t_h:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
