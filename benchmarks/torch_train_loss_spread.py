"""How far spx-100m's loss moves over `chip_smoke.py`'s training run,
with the flash backward kernels and with the plain float32 backward.

Trains TRAIN_RUN (spx-100m at full width, 20 steps of 8 x 1,024
synthetic tokens, the bf16 weight cast, a plane failing and healing)
from several init seeds, once with `flash_attention_bwd`'s kernels and
once with `ref.flash_attention_bwd_ref` in their place (the forward
kernel in both), and prints for each run the loss change over the run
of the first step's batch, of one batch no step trains on and of the
mean of four such batches.  At step 1 of the first seed every backward
call is also taken both ways: the least-squares slope of the kernel's
dQ, dK, dV on the plain ones and their relative error norm.

    PYTHONPATH=src python3 benchmarks/torch_train_loss_spread.py [--seeds N]

Needs one CUDA GPU (about 2 minutes with the build).
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planes import PlaneConfig  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.parallel import local_ctx  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    build.library()
    print(cs.card(), flush=True)
    kernel = fa._launch_bwd

    def plain(q, k, v, out, dout, lse, layout, causal, window):
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           causal=causal, window=window)

    stats = []

    def both(q, k, v, out, dout, lse, layout, causal, window):
        got = kernel(q, k, v, out, dout, lse, layout, causal, window)
        want = plain(q, k, v, out, dout, lse, layout, causal, window)
        for g, w in zip(got, want):
            g, w = g.double(), w.double()
            stats.append((float((g * w).sum() / (w * w).sum()),
                          float((g - w).norm() / w.norm())))
        return got

    spec = cs.TRAIN_RUN
    cfg = get_config(spec["arch"])
    first = next(cs.train_batches(cfg, spec))
    it = cs.train_batches(cfg, spec, start=spec["steps"])
    unseen = [next(it) for _ in range(4)]
    seed0 = spec["seed"]
    try:
        for seed in range(seed0, seed0 + args.seeds):
            for route in ("kernels", "plain"):
                fa._launch_bwd = kernel if route == "kernels" else plain
                tcfg = TrainerConfig(
                    plane=PlaneConfig(n_planes=4, microchunks=16),
                    warmup_steps=2, total_steps=spec["steps"],
                    cast_params_bf16=True,
                    ckpt_dir=str(ROOT / "build" / "loss_spread_ckpt"),
                    ckpt_every=10 * spec["steps"])
                params = init_params(cfg, torch.Generator(
                    device="cuda").manual_seed(seed), device="cuda")

                def losses(p):
                    return np.array([cs.batch_loss(cfg, p, b)
                                     for b in [first, *unseen]])

                before = losses(params)
                tr = Trainer(cfg, local_ctx(), tcfg, params)
                t0 = time.perf_counter()
                for i, batch in zip(range(spec["steps"]),
                                    cs.train_batches(cfg, spec)):
                    if i == spec["fail"][0]:
                        tr.inject_plane_failure(spec["fail"][1])
                    if i == spec["heal"][0]:
                        tr.heal_plane(spec["heal"][1])
                    if route == "kernels" and seed == seed0 and i == 1:
                        fa._launch_bwd = both
                        tr.train_step(batch)
                        fa._launch_bwd = kernel
                    else:
                        tr.train_step(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                d = losses(tr.params) - before
                print(f"seed {seed} {route}: first step's batch "
                      f"{before[0]:.6f} {d[0]:+.6f}; unseen batch "
                      f"{before[1]:.6f} {d[1]:+.6f}; mean of 4 unseen "
                      f"{before[1:].mean():.6f} {d[1:].mean():+.6f} "
                      f"({wall:.1f} s)", flush=True)
                del tr, params
                torch.cuda.empty_cache()
    finally:
        fa._launch_bwd = kernel
    s = np.array(stats)
    print(f"step 1 of seed {seed0}, {len(stats) // 3} backward calls: "
          f"slope of the kernels' gradients on the plain ones "
          f"{s[:, 0].min():.6f} to {s[:, 0].max():.6f}, relative error "
          f"norm {s[:, 1].min():.3e} to {s[:, 1].max():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
