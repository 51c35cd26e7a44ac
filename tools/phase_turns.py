#!/usr/bin/env python3
"""Run the end-to-end phases of ``chip_smoke.py`` from two trees of the
port in turns, on one card, and print their readings side by side.

    python3 tools/phase_turns.py PARENT_TREE CHANGE_TREE

For each tree in the order parent, change, change, parent, a fresh
process runs that tree's own ``chip_smoke.py`` functions: the kernel
build, the qwen2.5-3b serving slice, the mamba2-1.3b serving slice and
the training phase (each with all of its gates). It prints one JSON line
a run (serving tokens/s with p50 and p99 per token, healthy and through
the kill; the training step's median and the sync's share) and writes
them all to ``chiprun_out/phase_turns.jsonl``. Runs in turns on one card
are the only fair comparison of two trees: host-bound serving spreads
~1.9x from call to call.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r'''
import json, sys
sys.argv = ["chip_smoke.py"]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import close_data_group

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build_kernels()
out = {"card": cs.card_line()}
keys = ("tokens_per_s", "p50_ms", "p99_ms")
try:
    for name, arch, tag in (("qwen", cs.ARCH, "slice"),
                            ("mamba2", cs.SSM_ARCH, "ssm slice")):
        r = cs.slice_phase(get_config(arch), tag=tag)["runs"]
        out[name] = {run: {k: r[run][k] for k in keys}
                     for run in ("healthy", "burst")}
    t = cs.train_phase(get_config(cs.ARCH))
    out["train"] = {k: t[k] for k in ("step_s_median", "sync_share_median",
                                      "tokens_per_s", "peak_gib")}
finally:
    close_data_group()
print("RESULT " + json.dumps(out))
'''


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(argv[0]).resolve(),
             "change": Path(argv[1]).resolve()}
    out_dir = Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lines = []
    for which in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", RUN],
                              cwd=trees[which], capture_output=True,
                              text=True, timeout=1800)
        result = next((line[len("RESULT "):] for line in
                       proc.stdout.splitlines()
                       if line.startswith("RESULT ")), None)
        if proc.returncode != 0 or result is None:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{which}: exit {proc.returncode}")
        line = json.dumps({"tree": which, **json.loads(result)})
        print(line, flush=True)
        lines.append(line)
    (out_dir / "phase_turns.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
