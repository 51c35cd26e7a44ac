"""Small steps that break one step-pass rule each, recorded for real
through ``repro_torch.launch.steplog.record_step`` (imported by
``tests/test_torch_analysis.py`` on the CPU and by
``tests/test_torch_cuda.py`` on the card; no jax here).

Each step takes ``(p, x)``, updates ``p`` in place unless it breaks that
rule, and returns ``(p,)``; :data:`STEPS` maps a case to the step and
the rule it must trip (``None``: the good step, which trips none).
"""
import torch
import torch.distributed as dist

from repro_torch.dist.collectives import collective

#: copies a step leaves alive (module state, on purpose)
KEPT: list = []


def good(p, x):
    p.add_(x * 0.5)
    return (p,)


def host_read(p, x):
    p.add_(x.sum().item())
    return (p,)


def fp64(p, x):
    p.add_(x.double().sum().float())
    return (p,)


def rebound(p, x):
    return (p + x,)


def copy_alive(p, x):
    KEPT.append(p.clone())
    p.add_(x)
    return (p,)


def rng_draw(p, x):
    p.add_(torch.rand_like(p))
    return (p,)


def int8_all_reduce(p, x):
    q = x.to(torch.int8)
    collective(dist.all_reduce, q)
    p.add_(q.float())
    return (p,)


STEPS = {
    "good": (good, None),
    "host-read": (host_read, "hot-path-purity"),
    "fp64": (fp64, "hot-path-purity"),
    "rebound-leaf": (rebound, "donation-audit"),
    "copy-alive": (copy_alive, "donation-audit"),
    "rng-draw": (rng_draw, "hot-path-purity"),
    "int8-all-reduce": (int8_all_reduce, "wire-dtype-policy"),
}


def findings(case: str, device: str) -> set[str]:
    """Record case ``case``'s step once on ``device`` (on a fake group of
    2 ranks) and return the rules the step passes find in its log."""
    from repro_torch.analysis import (donation_audit, hot_path_purity,
                                      wire_dtype_policy)
    from repro_torch.launch.lint import fake_grid
    from repro_torch.launch.mesh import close_data_group
    from repro_torch.launch.steplog import record_step

    close_data_group()          # a group an earlier test file left up
    fn = STEPS[case][0]
    p = torch.zeros(64, device=device)
    x = torch.arange(64, dtype=torch.float32, device=device)
    with fake_grid(0, 2):
        try:
            _, log = record_step(fn, (p, x), donated=[p],
                                 returned=list, names=["p"])
        finally:
            KEPT.clear()
    assert not dist.is_initialized()
    found = (donation_audit(log, case) + hot_path_purity(log, case)
             + wire_dtype_policy(log, case))
    if device == "cuda" and case == "host-read":
        assert log.syncs, "the sync debug mode saw no sync"
    return {v.rule for v in found}
