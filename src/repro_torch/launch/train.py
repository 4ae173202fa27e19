"""Training driver.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch spx-100m \
      --steps 50 --batch 4 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --steps 20 --fail-plane 5:1 --heal-plane 12:1 --device cpu

The reference's flags and printed lines, plus `--device` (CUDA unless
`cpu` is given).  The weights are random, drawn from seed 0 on the
device.  On CUDA standard attention runs the hand-written kernels
forward and backward; they take head_dim 64, 128, 192 or 256, so the
`--reduced` configs (head_dim 16) raise there.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.planes import PlaneConfig
from repro_torch.data import DataConfig, DataLoader
from repro_torch.models import init_params, param_count
from repro_torch.netsim.engine import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import local_ctx
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spx-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--planes", type=int, default=4)
    ap.add_argument("--microchunks", type=int, default=16)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-plane", default=None,
                    help="step:plane plane-failure injection")
    ap.add_argument("--heal-plane", default=None, help="step:plane")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg.validate()
    ctx = local_ctx()
    device = resolve_device(args.device)

    tcfg = TrainerConfig(
        plane=PlaneConfig(n_planes=args.planes,
                          microchunks=args.microchunks,
                          compression=args.compression),
        adamw=AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    print(f"arch={cfg.name} params={param_count(params):,}", flush=True)
    if args.resume and args.ckpt_dir:
        trainer = Trainer.restore(cfg, ctx, tcfg, params)
        print(f"resumed at step {trainer.step}", flush=True)
    else:
        trainer = Trainer(cfg, ctx, tcfg, params)

    fail = tuple(map(int, args.fail_plane.split(":"))) \
        if args.fail_plane else None
    heal = tuple(map(int, args.heal_plane.split(":"))) \
        if args.heal_plane else None

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model)
    dl = DataLoader(dcfg, start_step=trainer.step)
    for i, batch in zip(range(trainer.step, args.steps), dl):
        if fail and i == fail[0]:
            trainer.inject_plane_failure(fail[1])
            print(f"step {i}: plane {fail[1]} FAILED", flush=True)
        if heal and i == heal[0]:
            trainer.heal_plane(heal[1])
            print(f"step {i}: plane {heal[1]} healed", flush=True)
        m = trainer.train_step({k: torch.as_tensor(v, device=device)
                                for k, v in batch.items()})
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} "
                  f"t {m['step_time_s'] * 1e3:.0f}ms "
                  f"planes {m['planes_up']} "
                  f"eff_bw {m['plane_eff_bw']:.2f}", flush=True)
    if args.ckpt_dir:
        trainer.save()
        print("final checkpoint saved", flush=True)
    recs = [{"plane": r.plane, "fail_step": r.fail_step,
             "recovery_steps": r.recovery_steps}
            for r in trainer.failover.records]
    print(json.dumps({"final_loss": trainer.history[-1]["loss"],
                      "failovers": recs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
