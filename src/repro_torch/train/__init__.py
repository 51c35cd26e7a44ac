from .injection import ScenarioInjector, ScriptedInjector, StepEvent
from .step import (make_prefill, make_serve_step, make_train_step,
                   weighted_loss)

__all__ = ["make_serve_step", "make_prefill", "make_train_step",
           "weighted_loss", "ScenarioInjector", "ScriptedInjector",
           "StepEvent"]
