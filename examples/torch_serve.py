"""Serve a model with batched requests on the PyTorch port: prefill, then
greedy decode.

    PYTHONPATH=src python examples/torch_serve.py [--arch granite-3-2b]
        [--batch 4] [--prompt-len 32] [--steps 16] [--device cuda]

The PyTorch counterpart of examples/serve.py, on ``repro_torch``: the
reduced config of ``--arch`` with random weights from seed 0, on the card
(``--device cuda``, the default) unless ``--device cpu`` is given. The same
prefill/decode step functions run every family's caches: a ring KV cache
under a sliding window (mixtral), MLA's latent cache (deepseek-v3), Mamba
states (falcon-mamba, zamba2, whose shared attention keeps one cache per
group) and the encoder-decoder's static cross K/V (seamless-m4t). The last
line prints the generated tokens of the first request.
"""
import argparse
import time

import torch

import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.serve.step import greedy_generate
from repro_torch.train.step import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="granite-3-2b", choices=C.ARCHS + C.EXTRA)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--prompt-len", type=int, default=32)
ap.add_argument("--steps", type=int, default=16)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda)")
args = ap.parse_args()

device = resolve_device(args.device)
cfg = C.get_smoke(args.arch)
params = build_model(cfg).init(0, device)
prompt = synthetic_batch(cfg, args.batch, args.prompt_len, 0)

t0 = time.time()
out = greedy_generate(cfg, params, prompt, steps=args.steps,
                      max_len=args.prompt_len + args.steps)
if device.type == "cuda":
    torch.cuda.synchronize(device)
wall = time.time() - t0
print(f"arch={args.arch} family={cfg.family} device={device}")
print(f"generated {args.batch}x{args.steps} tokens in {wall:.2f}s "
      f"({args.batch * args.steps / wall:.1f} tok/s)")
print("tokens of request 0:", out[0].tolist())
