"""repro_torch.analysis — static SPARe-invariant verification of the
port (the counterpart of ``repro.analysis``).

The paper's recovery math holds only if the step programs are
well-behaved: masking must stay pure weight-table data (identical
collective schedules for every recoverable survivor set), the state
must be updated in place (a silent 2x memory cost otherwise), steps
must stay free of host reads and fp64, and the int8 wire payloads must
never be summed by a reducing collective. This package turns those
into passes any program — and CI — can run:

* **step passes** (:mod:`.step_passes`) read one recorded step
  (:mod:`repro_torch.launch.steplog`), the port's counterpart of the JAX
  package's compiled HLO: ``collective-schedule-determinism``,
  ``donation-audit``, ``hot-path-purity``, ``wire-dtype-policy``.
* **AST passes** (:mod:`.ast_passes`, a copy of the JAX package's) lint
  the port's Python source: ``determinism`` (wall-clock reads, unseeded
  RNG, set-iteration order, PYTHONHASHSEED-dependent ``hash()``,
  mutable defaults) and ``thread-shared-state`` (thread-target closures
  touching shared mutable state outside the submit-argument channel).

``python -m repro_torch.launch.lint`` runs them; findings render as
a deterministic JSON + text report and a single line suppresses a
reviewed one: ``# lint: ignore[<rule>]``.
"""
from repro_torch.analysis.core import (Report, Violation, iter_source_files,
                                       suppressed_lines)
from repro_torch.analysis.ast_passes import (AST_PASSES, lint_source,
                                             run_ast_passes)
from repro_torch.analysis.step_passes import (STEP_PASSES, donation_audit,
                                              hot_path_purity,
                                              schedule_determinism_cell,
                                              schedule_determinism_executor,
                                              wire_dtype_policy)

__all__ = [
    "Report", "Violation", "iter_source_files", "suppressed_lines",
    "AST_PASSES", "lint_source", "run_ast_passes",
    "STEP_PASSES", "donation_audit", "hot_path_purity",
    "schedule_determinism_cell", "schedule_determinism_executor",
    "wire_dtype_policy",
]
