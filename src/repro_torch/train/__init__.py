from .injection import ScriptedInjector, StepEvent
from .step import make_prefill, make_serve_step

__all__ = ["make_serve_step", "make_prefill", "ScriptedInjector",
           "StepEvent"]
