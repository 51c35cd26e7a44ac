#!/usr/bin/env python3
"""Reproduce the abort of a two-rank gloo program at its exit
("terminate called without an active exception"), and count it.

    PYTHONPATH=src python tools/gloo_exit_repro.py pairs VARIANT [ROUNDS]
        [PAIRS]
    PYTHONPATH=src python tools/gloo_exit_repro.py pytest TREE [ITERATIONS]

CPU only; no card, no network (rendezvous through a ``FileStore``).

``pairs`` starts ``PAIRS`` pairs of processes at once, ``ROUNDS`` times,
beside one busy process per CPU (the abort needs a loaded machine: its
window is a worker thread that has not run yet when its process exits).
Each pair makes a two-rank gloo group, runs the int8-EF sync's
collectives (all_reduce, all_to_all, all_gather) six times on fresh
tensors, tears the group down with ``destroy_process_group`` and exits,
holding the group and the last round's tensors until the interpreter
exits (as the two-rank test's worker does with module-level names); it
prints how many pairs had a rank die, and the last lines each dead rank
printed. ``VARIANT``:

* ``plain``: as above;
* ``barrier``: ``dist.barrier()`` before the teardown;
* ``settle``: every collective through
  ``repro_torch.dist.collectives.collective`` (the port's repair: it
  returns once gloo's worker thread has let go of the tensors).

``pytest`` runs ``tests/test_torch_collectives.py::
test_syncs_on_two_ranks_match_jax_vmap`` in the checkout ``TREE`` six
times at once (``-n 6 --dist each``), ``ITERATIONS`` times, and prints
the failed runs and the runs whose output holds "terminate called".
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

TEST = ("tests/test_torch_collectives.py::"
        "test_syncs_on_two_ranks_match_jax_vmap")


def rank_main(rank: int, store: str, variant: str) -> list:
    import torch
    import torch.distributed as dist

    from repro_torch.dist.collectives import collective

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    g = dist.group.WORLD

    def run(op, *ts):
        if variant == "settle":
            collective(op, *ts, group=g)
        else:
            op(*ts, group=g)

    for _ in range(6):
        t = torch.randn(4096)
        run(dist.all_reduce, t)
        x, xi = torch.empty(4096, dtype=torch.int8), t.to(torch.int8)
        run(dist.all_to_all_single, x, xi)
        s, t1 = torch.empty(2), t[:1].contiguous()
        run(dist.all_gather_into_tensor, s, t1)
        q, x2 = torch.empty(4096, dtype=torch.int8), x[:2048].contiguous()
        run(dist.all_gather_into_tensor, q, x2)
    if variant == "barrier":
        dist.barrier()
    dist.destroy_process_group()
    return [g, t, x, xi, s, t1, q, x2]


def _pair(tmp: str, name: str, variant: str) -> list:
    store = os.path.join(tmp, name)
    return [subprocess.Popen(
        [sys.executable, __file__, "rank", str(rank), store, variant],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]


def pairs(variant: str, rounds: int, n_pairs: int) -> None:
    dead, total, tails = 0, 0, set()
    load = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(os.cpu_count() or 1)]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for r in range(rounds):
                procs = [_pair(tmp, f"store_{r}_{k}", variant)
                         for k in range(n_pairs)]
                for pair in procs:
                    outs = [p.communicate(timeout=300)[0] for p in pair]
                    bad = [i for i, p in enumerate(pair) if p.returncode]
                    total += 1
                    dead += bool(bad)
                    tails.update(
                        f"rank {i}, exit {pair[i].returncode}: "
                        + " | ".join(outs[i].strip().splitlines()[-2:])
                        for i in bad)
    finally:
        for proc in load:
            proc.kill()
            proc.wait()
    print(f"{variant}: {dead} of {total} pairs had a rank die")
    for t in sorted(tails):
        print("  " + t)


def pytest_loop(tree: str, iterations: int) -> None:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    failed = aborted = 0
    for i in range(iterations):
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "xdist", "-n", "6", "--dist", "each", TEST], cwd=tree,
            env=env, capture_output=True, text=True, timeout=900).stdout
        summary = [ln for ln in out.splitlines() if " passed" in ln
                   or " failed" in ln][-1:]
        n_failed = int(summary[0].split(" failed")[0].split()[-1]) \
            if summary and " failed" in summary[0] else 0
        failed += n_failed
        aborted += out.count("terminate called")
        print(f"iteration {i + 1}: {summary[0] if summary else out[-200:]}",
              flush=True)
    print(f"{tree}: {failed} of {6 * iterations} runs failed, "
          f"{aborted} with \"terminate called\"")


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "rank":
        KEEP = rank_main(int(args[0]), args[1], args[2])
    elif cmd == "pairs":
        pairs(args[0], int(args[1]) if len(args) > 1 else 10,
              int(args[2]) if len(args) > 2 else 6)
    elif cmd == "pytest":
        pytest_loop(args[0], int(args[1]) if len(args) > 1 else 40)
    else:
        raise SystemExit(__doc__)
