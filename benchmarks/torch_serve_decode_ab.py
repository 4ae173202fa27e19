"""Decode ms a step of two served models in this checkout and in another
(`--parent DIR`, e.g. a `git archive` of the parent commit unpacked
under `build/`), in turns parent, this, this, parent, each turn a
process of its own that builds its tree's kernels and runs its tree's
`chip_smoke.py` helpers:

- llama3-8b at full width and depth in bfloat16 (`chip_smoke.SERVE_RUNS`
  [0]: batch 4, a 1,024-slot ring, six requests of 16 new tokens), the
  standard attention's cache write and `decode_attention_bshd` every
  layer a step;
- deepseek-v2 at full width cut to 2 layers (`chip_smoke.TP_MLA` and its
  serve spec), without a mesh: MLA's absorbed decode over the latent
  cache.

Each turn serves each model four times and prints one JSON line a run: the
median and mean decode ms a step (`serve_engine`'s synchronised walls)
and the steps.  The last line is a JSON summary by tree and model, with
the card's name and power limit.  Needs one CUDA GPU and `nvcc`:

    python3 benchmarks/torch_serve_decode_ab.py --parent build/parent
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import dataclasses, json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.models import init_params
build.library()
torch.backends.cuda.matmul.allow_tf32 = False
out = []
for model in ("llama3-8b", "deepseek-v2"):
    if model == "llama3-8b":
        spec = cs.SERVE_RUNS[0]
        cfg = dataclasses.replace(cs._serve_cfg(spec), dtype="bfloat16")
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            spec["seed"]), device="cuda")
    else:
        cfg, params = cs.tp_model(cs.TP_MLA)
        spec = cs.TP_MLA["serve"]
    for run in range(4):
        rec = cs.serve_engine(cfg, params, spec)
        ms = sorted(t * 1e3 for t in rec["decode_s"])
        line = dict(tree=sys.argv[1], model=model, run=run,
                    decode_ms_median=ms[len(ms) // 2],
                    decode_ms_mean=sum(ms) / len(ms), steps=len(ms))
        print(json.dumps(line), flush=True)
        del rec
    del params
    torch.cuda.empty_cache()
"""


def turn(label: str, tree: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD, label], cwd=tree,
                         env=env, capture_output=True, text=True)
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        raise SystemExit(f"{label} ({tree}) exited {res.returncode}")
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    for x in lines:
        print(json.dumps(x), flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    runs = []
    for label in ("parent", "this", "this", "parent"):
        runs += turn(label, trees[label])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    summary = {f"{t} {m}": sorted(round(r["decode_ms_median"], 3)
                                  for r in runs
                                  if r["tree"] == t and r["model"] == m)
               for t in trees for m in ("llama3-8b", "deepseek-v2")}
    print(json.dumps(dict(card=card, decode_ms_medians=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
