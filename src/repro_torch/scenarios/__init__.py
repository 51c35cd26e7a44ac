"""Scenario engine of the port: cluster topology, failure models and the
campaign runner (copies of the JAX package's jax-free
``repro.scenarios.models`` and ``repro.scenarios.topology``, and its
campaign runner over the port's trainer).

The failure models and topology feed the DES engine
(:mod:`repro_torch.des.engine`) and the live
:class:`repro_torch.train.injection.ScenarioInjector` bridge; the three
bundled synthetic traces are copies of the JAX package's.
:mod:`repro_torch.scenarios.campaign` sweeps scheme x scale x
failure-regime grids across spawned worker processes with
deterministic per-cell seeding into byte-stable CSV/JSON artifacts
(CLI: ``python -m repro_torch.launch.campaign``), and drives the port's
trainer and mesh executor through the live-trainer and gray-failure
cells.
"""
from .topology import ClusterTopology, TOPOLOGY_PRESETS, topology_from_spec
from .models import (
    FailureModel,
    RenewalModel,
    PoissonModel,
    CorrelatedModel,
    DiurnalModel,
    TraceReplayModel,
    SuperposedModel,
    SlowdownModel,
    FailSlowModel,
    FlakyLinkModel,
    get_failure_model,
    list_failure_models,
    register_failure_model,
    model_from_spec,
    bundled_traces,
    load_trace,
    sample_kill_batches,
    bind_model,
    drain_event_window,
    drain_slow_window,
    to_step_events,
)
from .campaign import (
    CampaignSpec,
    ScenarioCell,
    CAMPAIGN_PRESETS,
    cell_seed,
    run_cell,
    run_campaign,
    parallel_map,
    aggregate,
    ranking_by_regime,
    save_artifacts,
)

__all__ = [
    "ClusterTopology", "TOPOLOGY_PRESETS", "topology_from_spec",
    "FailureModel", "RenewalModel", "PoissonModel", "CorrelatedModel",
    "DiurnalModel", "TraceReplayModel", "SuperposedModel",
    "SlowdownModel", "FailSlowModel", "FlakyLinkModel",
    "get_failure_model", "list_failure_models", "register_failure_model",
    "model_from_spec", "bundled_traces", "load_trace", "sample_kill_batches",
    "bind_model", "drain_event_window", "drain_slow_window", "to_step_events",
    "CampaignSpec", "ScenarioCell", "CAMPAIGN_PRESETS", "cell_seed",
    "run_cell", "run_campaign", "parallel_map", "aggregate",
    "ranking_by_regime", "save_artifacts",
]
