"""Assigned input shapes (one set shared by all 10 LM archs).

  train_4k     seq 4,096   global_batch 256   (training; lowers train_step)
  prefill_32k  seq 32,768  global_batch 32    (inference prefill)
  decode_32k   seq 32,768  global_batch 128   (decode: 1 token, 32k KV)
  long_500k    seq 524,288 global_batch 1     (long-context decode)

``decode_*``/``long_*`` lower ``serve_step`` (one new token against a
KV/SSM cache of ``seq``), NOT ``train_step``. long_500k requires
sub-quadratic attention: only the ssm/hybrid families run it; pure
full-attention archs record a documented skip (DESIGN.md §long-context).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable", "cells"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (O(seq) KV readback per "
            "decoded token at 524k context) — documented skip")
    return True, ""


def cells(cfg: ModelConfig) -> list[tuple[ShapeSpec, bool, str]]:
    """All four assigned cells for one arch with applicability verdicts."""
    return [(s, *applicable(cfg, s)) for s in SHAPES.values()]
