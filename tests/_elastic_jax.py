"""The JAX package's side of ``tests/test_torch_elastic.py``: the cases of
``tests/_elastic_cases.py`` on its ``ElasticMeshExecutor`` over 4
emulated CPU devices, and the three elastic campaign arms at ``n=4``.
A script of its own, because the device count is fixed when jax is
first imported:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_elastic_jax.py cases PARAMS.pkl OUT.pkl
    ... python tests/_elastic_jax.py arms OUT.pkl

``cases``: ``PARAMS.pkl`` holds the numpy parameters both sides start
from, and ``OUT.pkl`` receives, per case, what
:func:`_elastic_cases.port_rank` records, with each physical rank's
state cut from the global arrays. ``arms``: the rows of
``run_elastic_cell`` for ``elastic_regime_cells(n=4)``.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _elastic_cases import (ARCH, CASES, KW, N, SPS, TINY,  # noqa: E402
                           SlowGroups, summary)

from repro.configs import smoke_config  # noqa: E402
from repro.des import get_scheme  # noqa: E402
from repro.elastic import ElasticMeshExecutor  # noqa: E402
from repro.optim import adamw_init  # noqa: E402
from repro.scenarios.campaign import (elastic_regime_cells,  # noqa: E402
                                      run_elastic_cell)
from repro.train.injection import ScriptedInjector  # noqa: E402
from repro.train.trainer import TrainReport  # noqa: E402


def cases(params_path: str, model_degree: int = 1,
          cases=CASES) -> dict:
    """The cases on an ``(N, model_degree)`` mesh, the policy cases as
    :func:`_elastic_cases.port_rank` takes them; each state in grid-rank
    order (device ``d * model_degree + m``)."""
    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(**TINY)
    m_deg = model_degree

    def executor(**kw):
        args = dict(KW, grad_compress="int8_ef", model_degree=m_deg)
        args.update(kw)
        ex = ElasticMeshExecutor(cfg, **args)
        ex.params = jax.device_put(jax.tree.map(jnp.asarray, numpy_params),
                                   ex._pshard)
        ex.opt_state = jax.device_put(adamw_init(ex.params), ex._oshard)
        return ex

    def state(ex) -> list:
        """Per physical rank: the replicas, and its rows of the EF
        residuals' global arrays (retired ranks: none)."""
        host = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]  # noqa
        params, mu, nu = (host(ex.params), host(ex.opt_state.mu),
                          host(ex.opt_state.nu))
        rows = [int(p) for p in ex._logical_phys]
        n = len(rows)
        out = [None] * (N * m_deg)
        for i, p in enumerate(rows):
            err1 = [np.asarray(e).reshape(n, -1)[i]
                    for e in ex._ef_state["err1"]]
            err2 = [np.asarray(e).reshape(n, -1)[i]
                    for e in ex._ef_state["err2"]]
            for m in range(m_deg):
                out[p * m_deg + m] = {
                    "params": params, "mu": mu, "nu": nu,
                    "opt_step": int(ex.opt_state.step),
                    "err1": err1, "err2": err2}
        return out

    def common(ex, rep=None, inj=None) -> dict:
        return {"report": None if rep is None else summary(rep),
                "n": int(ex.state.n), "r": int(ex.state.r),
                "rows": [int(p) for p in ex._logical_phys],
                "cache_keys": [list(k) for k in ex.cache_keys],
                "policy_log": list(ex.policy_log),
                "outage_s": None if inj is None else inj.outage_seconds}

    out: dict = {}

    ex = executor()
    ex.run(3)
    s0 = state(ex)
    ex.reshape([0, 1])
    s1, after = state(ex), common(ex)
    ex.restore_full_mesh()
    out["round_trip"] = {"s0": s0, "s1": s1, "s2": state(ex),
                         "after_reshape": after, **common(ex)}
    ex.close()

    ex = executor()
    ex.reshape([0, 1])
    rep = ex.run(3)
    out["fresh"] = {"elastic": {"state": state(ex), **common(ex, rep)}}
    ex.close()

    ex = executor()
    inj = ScriptedInjector({4: [0, 1]}, seconds_per_step=SPS)
    out["burst"] = common(ex, ex.run(12, injector=inj, snapshot_every=10),
                          inj)
    ex.close()

    ex = executor()
    inj = ScriptedInjector({4: [0, 1], 8: [2]}, seconds_per_step=SPS)
    out["cascade"] = common(ex, ex.run(12, injector=inj, snapshot_every=4),
                            inj)
    ex.close()

    ex = executor()
    ex.run(4, snapshot_every=4)
    keys_before = [list(k) for k in ex.cache_keys]
    ex.reshape([0, 1])
    ex.run(2)
    ex._global_restart()
    restarted = {"phys_alive": ex._phys_alive.tolist(), **common(ex)}
    rep = ex.run(2)
    out["restart"] = {"keys_before": keys_before, "restarted": restarted,
                      "state": state(ex), **common(ex, rep)}
    ex.close()

    ex = executor()
    ex.run(3)
    ex.reshape([0, 1])
    at_snapshot = state(ex)
    ex.run(2)
    ex._global_restart()
    step, (ex.params, ex.opt_state) = ex._rollback()
    out["rollback"] = {"at_snapshot": at_snapshot, "step": step,
                       "state": state(ex), **common(ex)}
    ex.close()

    if "adaptive" in cases:
        scheme = get_scheme("adaptive", r=2, initial="spare")
        ex = executor(scheme=scheme, grad_compress=None)
        inj = ScriptedInjector({4: [0, 1]}, seconds_per_step=SPS)
        rep = ex.run(8, injector=inj, snapshot_every=4)
        out["adaptive"] = {"decisions": list(scheme.unmaskable_decisions),
                           **common(ex, rep, inj)}
        ex.close()

    if "mask" in cases:
        ex = executor(grad_compress=None)
        inj = ScriptedInjector({3: [0]}, seconds_per_step=SPS)
        out["mask"] = common(ex, ex.run(8, injector=inj), inj)
        ex.close()

    ex = executor()
    ex.run(2)
    rep = TrainReport()
    ex._health_reshape([0, 1], SlowGroups([3.0, 3.0, 1.0, 1.0]), None, rep)
    after = common(ex, rep)
    out["health"] = {"after": after, **common(ex, ex.run(2))}
    ex.close()

    return out


def main(part: str, *paths: str) -> None:
    assert jax.device_count() == N, jax.devices()
    if part == "cases":
        out = cases(paths[0])
    else:
        out = [run_elastic_cell(c) for c in elastic_regime_cells(n=N)]
    with open(paths[-1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
