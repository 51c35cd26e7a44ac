"""The JAX package's side of ``tests/test_torch_elastic_grid.py``. A
script of its own, because the device count is fixed when jax is first
imported:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src python tests/_elastic_grid_jax.py cases PARAMS.pkl OUT.pkl
    ... (16 devices) python tests/_elastic_grid_jax.py cells OUT.pkl

``cases``: the cases of ``tests/_elastic_grid_cases.py`` on the
``ElasticMeshExecutor`` over a ``(4, 2)`` emulated mesh, from the numpy
parameters in ``PARAMS.pkl``: the int8 EF ones of ``GRID_CASES``
(``_elastic_jax.cases`` at model degree 2)
and the gspmd round trip and rollback. ``cells``: the rows of
``run_elastic_cell`` for ``elastic_regime_cells(n=2, r=1,
model_degree=2, steps=12)`` (a ``(2, 2)`` mesh) and of ``run_gray_cell``
for ``gray_regime_cells(model_degree=2, steps=16, slow_step=1,
heal_step=5)`` (an ``(8, 2)`` mesh).
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _elastic_cases import ARCH, TINY, summary  # noqa: E402
from _elastic_grid_cases import (DEVICES, ELASTIC_CELLS,  # noqa: E402
                                 GRAY_CELLS, GRID_CASES, GSPMD_KW, M)
from _elastic_jax import cases as int8_cases  # noqa: E402

from repro.configs import smoke_config  # noqa: E402
from repro.elastic import ElasticMeshExecutor  # noqa: E402
from repro.optim import adamw_init  # noqa: E402
from repro.scenarios.campaign import (elastic_regime_cells,  # noqa: E402
                                      gray_regime_cells, run_elastic_cell,
                                      run_gray_cell)


def gspmd_cases(params_path: str) -> dict:
    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(**TINY)

    def executor():
        ex = ElasticMeshExecutor(cfg, **GSPMD_KW)
        ex.params = jax.device_put(jax.tree.map(jnp.asarray, numpy_params),
                                   ex._pshard)
        ex.opt_state = jax.device_put(adamw_init(ex.params), ex._oshard)
        return ex

    def host(t) -> list:
        return [np.asarray(x) for x in jax.tree.leaves(t)]

    def state(ex) -> dict:
        return {"full": host(ex.params), "full_mu": host(ex.opt_state.mu),
                "full_nu": host(ex.opt_state.nu),
                "opt_step": int(ex.opt_state.step)}

    def common(ex, rep=None) -> dict:
        return {"report": None if rep is None else summary(rep),
                "n": int(ex.state.n), "r": int(ex.state.r),
                "rows": [int(p) for p in ex._logical_phys],
                "cache_keys": [list(k) for k in ex.cache_keys]}

    out: dict = {}
    ex = executor()
    ex.run(3)
    s0 = state(ex)
    ex.reshape([0, 1])
    s1, after = state(ex), common(ex)
    rep = ex.run(1)
    s_mid = state(ex)
    ex.restore_full_mesh()
    out["round_trip"] = {"s0": s0, "s1": s1, "s_mid": s_mid,
                         "s2": state(ex), "after_reshape": after,
                         "degraded": summary(rep), **common(ex)}
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
    return out


def main(part: str, *paths: str) -> None:
    assert jax.device_count() == DEVICES[part], jax.devices()
    if part == "cases":
        out = {"int8": int8_cases(paths[0], model_degree=M,
                                  cases=GRID_CASES),
               "gspmd": gspmd_cases(paths[0])}
    else:
        out = {"elastic": [run_elastic_cell(c) for c in
                           elastic_regime_cells(**ELASTIC_CELLS)],
               "gray": [run_gray_cell(c) for c in
                        gray_regime_cells(**GRAY_CELLS)]}
    with open(paths[-1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
