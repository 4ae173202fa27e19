"""Serving launcher: batched decode over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --reduced --requests 8 --max-new 16 --device cpu

Runs on CUDA unless `--device cpu` is given; the weights are random,
drawn from seed 0 on the device.  On CUDA standard attention runs the
hand-written kernels, which take head_dim 64, 128, 192 or 256: the
`--reduced` configs (head_dim 16) raise there.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params, param_count
from repro_torch.netsim.engine import resolve_device
from repro_torch.parallel.sharding import local_ctx
from repro_torch.train import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spx-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg.validate()
    ctx = local_ctx()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    print(f"arch={cfg.name} params={param_count(params):,}", flush=True)

    eng = ServeEngine(cfg, ctx, params, batch=args.batch,
                      max_len=args.max_len)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32), args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s)", flush=True)
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
