"""The port's dry run (``repro_torch.launch.dryrun``), its analyzer
(``launch.analyze``) and the kernels' fake routes, on the CPU.

A storage-free (``meta``) tensor takes each kernel's card route to a
fake implementation while the dry run traces (``ops.tracing_card``),
allocating what the launch allocates: its outputs must have the plain
version's shapes and dtypes, and nothing is launched. The production
cells trace the FSDP x TP step of rank 0 of a fake grid of 256 (or 512)
ranks; here at 2 layers (the record's bytes
are checked against the rule table's blocks, its FLOPs against the
model's). ``long_500k`` on qwen2.5-3b is the JAX package's skip, word
for word. Every dense arch records each of its cells at 2 layers on
both meshes (the untied head, the two-matrix MLPs, the padded head
blocks where 16 does not divide the heads, and the frontends' bf16
``embeds``), and every other arch is a failed cell naming its
``ROADMAP.md`` §1 item (1.3 to 1.6). The parity of the dry run's bytes
with JAX's ``memory_analysis()`` and of its schedule with the gloo
ranks' is in ``tests/test_torch_fsdp_tp.py`` and
``tests/test_torch_fsdp_tp_families.py``.
"""
import json

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.dist import tree_leaves
from repro_torch.dist.sharding import param_specs, spec_leaves
from repro_torch.kernels import ops
from repro_torch.launch import analyze, dryrun
from repro_torch.launch.mesh import PRODUCTION_AXES, close_data_group
from repro_torch.launch.steplog import Collective, StepCost, StepLog
from repro_torch.models.attention import tp_heads
from repro_torch.models.model import Model, mesh_refusal

ARCH = "qwen2.5-3b"
#: the archs the FSDP x TP program runs, and the ROADMAP.md item of each
#: one it refuses
DENSE = [a for a in ARCHS if mesh_refusal(get_config(a)) is None]
REFUSED = {"deepseek-v2-lite-16b": "1.4", "deepseek-v3-671b": "1.6",
           "mamba2-1.3b": "1.5", "jamba-v0.1-52b": "1.5"}


@pytest.fixture(autouse=True)
def _no_group():
    # a default group left up by another test file would make the fake
    # grid raise
    close_data_group()


def _inputs(name: str, device: str) -> dict:
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.bfloat16, grad=True):
        x = torch.randn(*shape, generator=g).to(dtype).to(device)
        return x.requires_grad_(grad)

    if name.startswith("rmsnorm"):
        return {"x": t(2, 8, 64), "w": t(64, dtype=torch.float32)}
    if name.startswith("flash"):
        return {"q": t(1, 32, 4, 16), "k": t(1, 32, 2, 16),
                "v": t(1, 32, 2, 16)}
    if name.startswith("ssd"):
        return {"x": t(1, 32, 4, 16), "dt": t(1, 4, 32, dtype=torch.float32),
                "a_log": t(4, dtype=torch.float32), "b": t(1, 32, 1, 16),
                "c": t(1, 32, 1, 16)}
    return {"grad": t(1000, dtype=torch.float32, grad=False),
            "error": t(1000, dtype=torch.float32, grad=False)}


def _call(name: str, a: dict):
    """The wrapper's outputs, and with a ``_bwd`` name the inputs'
    gradients of their sum."""
    if name.startswith("rmsnorm"):
        outs = (ops.rmsnorm(a["x"], a["w"]),)
    elif name.startswith("flash"):
        outs = (ops.flash_attention(*(a[k].transpose(1, 2)
                                      for k in ("q", "k", "v"))),)
    elif name.startswith("ssd"):
        outs = ops.ssd_scan(a["x"].transpose(1, 2), a["dt"], a["a_log"],
                            a["b"].transpose(1, 2), a["c"].transpose(1, 2),
                            chunk=16)
    else:
        outs = ops.int8_ef_quantize(a["grad"], a["error"])
    if not name.endswith("_bwd"):
        return list(outs)
    sum(o.float().sum() for o in outs).backward()
    return [a[k].grad for k in a]


@pytest.mark.parametrize("name", ["rmsnorm", "rmsnorm_bwd",
                                  "flash_attention", "flash_attention_bwd",
                                  "ssd_scan", "ssd_scan_bwd", "int8_ef"])
def test_fake_route_matches_the_plain_version(name):
    """Each card route's fake outputs (and gradients) have the plain
    version's shapes and dtypes, and launch nothing."""
    ops.reset_launches()
    with ops.tracing_card():
        fake = _call(name, _inputs(name, "meta"))
    plain = _call(name, _inputs(name, "cpu"))
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in fake)
    assert not any(ops.launches.values())


def _block_bytes(cfg, axes: dict, multi_pod: bool) -> int:
    """A rank's parameter, moment (fp32) and batch bytes, reckoned from
    the rule table: each leaf's size over the product of the axes its
    spec names."""
    params = Model(cfg, torch.device("meta")).init(0)
    specs = param_specs(params, cfg, multi_pod, axes)
    total = 0
    for leaf, spec in zip(tree_leaves(params), spec_leaves(specs, params)):
        n = leaf.numel()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)) if e else ():
                n //= axes[a]
        total += n * (leaf.element_size() + 8)
    return total


@pytest.mark.parametrize("shape,multi_pod", [
    ("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
    ("train_4k", True)])
def test_production_record_at_two_layers(shape, multi_pod):
    rec = dryrun.run_cell(ARCH, shape, multi_pod, overrides={"n_layers": 2})
    axes = PRODUCTION_AXES["multi_pod" if multi_pod else "single_pod"]
    keys = ("arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes", "flops_per_device", "bytes_per_device",
            "collectives", "model_flops_per_device", "useful_flops_ratio",
            "roofline", "bottleneck")
    assert rec["ok"] and all(k in rec for k in keys)
    assert rec["devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    cfg = get_config(ARCH).scaled(n_layers=2)
    if SHAPES[shape].kind == "train":
        dp = 32 if multi_pod else 16
        s = SHAPES[shape]
        batch = 4 * s.global_batch // dp * (2 * s.seq + 1)
        assert rec["arg_bytes"] == _block_bytes(cfg, axes, multi_pod) + 4 \
            + batch
        assert rec["alias_bytes"] == rec["arg_bytes"] - batch
        # the products: 6 N D, the attention's and the logits' remat
        assert 0.7 < rec["useful_flops_ratio"] < 1.0
        assert set(rec["collectives"]["counts"]) == {
            "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor"}
    assert rec["peak_bytes"] > rec["arg_bytes"] > 0
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["roofline"]["memory_lb_s"] < rec["roofline"]["memory_s"]


def test_production_cell_takes_the_card_route():
    """The traced step reaches K1, K1-bwd, K2 and K2-bwd, each by its
    fake implementation, and its FLOPs count K2's causal products."""
    cell, _ = dryrun.record_cell(ARCH, "train_4k", False,
                                 overrides={"n_layers": 1})
    kernels = {op for op, _ in cell.cost.traffic}
    assert {"rmsnorm", "rmsnorm_bwd", "flash_attention",
            "flash_attention_bwd"} <= kernels
    assert "softmax" not in " ".join(kernels)
    calls = {op: sum(v[1] for (o, _), v in cell.cost.traffic.items()
                     if o == op) for op in ("flash_attention",
                                            "flash_attention_bwd")}
    # four microbatches: the forward and its remat, then the backward
    assert calls == {"flash_attention": 8, "flash_attention_bwd": 4}


def test_long_500k_is_the_jax_skip():
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import applicable as jax_applicable
    from repro.configs import get_config as jax_config

    rec = dryrun.run_cell(ARCH, "long_500k", False)
    want = jax_applicable(jax_config(ARCH), JAX_SHAPES["long_500k"])[1]
    assert rec["ok"] and rec["skipped"] and rec["reason"] == want


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in DENSE])
def test_other_archs_are_failed_cells_naming_their_roadmap_item(arch,
                                                                tmp_path):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", arch, "--shape", "train_4k",
                     "--out-dir", str(tmp_path)])
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert not rec["ok"] and not rec.get("skipped")
    assert rec["error"].startswith("NotImplementedError")
    assert "ROADMAP.md" in rec["error"]
    assert f"ROADMAP.md §1 item {REFUSED[arch]})" in rec["error"]


def test_the_program_runs_every_dense_config_and_refuses_the_rest():
    assert DENSE == [a for a in ARCHS if get_config(a).family == "dense"]
    assert set(DENSE) == {"qwen2.5-3b", "glm4-9b", "starcoder2-7b",
                          "minitron-4b", "qwen2-vl-2b", "musicgen-medium"}
    assert set(REFUSED) == set(ARCHS) - set(DENSE)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", DENSE)
def test_dense_archs_record_every_cell_at_two_layers(arch, shape,
                                                     multi_pod):
    """Each cell is ``ok`` (``long_500k`` the JAX package's skip); a train
    cell's arguments are the rule table's blocks, the rank's batch
    (tokens, or a frontend's bf16 embeds) and the step counter."""
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import applicable as jax_applicable
    from repro.configs import get_config as jax_config

    rec = dryrun.run_cell(arch, shape, multi_pod, overrides={"n_layers": 2})
    assert rec["ok"], rec.get("error")
    runs, why = jax_applicable(jax_config(arch), JAX_SHAPES[shape])
    if not runs:
        assert rec["skipped"] and rec["reason"] == why
        return
    assert rec["peak_bytes"] >= rec["arg_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["collectives"]["total_bytes"]
    cfg = get_config(arch).scaled(n_layers=2)
    s = SHAPES[shape]
    if s.kind != "train":
        return
    axes = PRODUCTION_AXES["multi_pod" if multi_pod else "single_pod"]
    dp = 32 if multi_pod else 16
    per = s.global_batch // dp * s.seq
    x = per * 2 * cfg.d_model if cfg.frontend else per * 4
    batch = per * 4 + s.global_batch // dp * 4 + x
    assert rec["arg_bytes"] == _block_bytes(cfg, axes, multi_pod) + 4 \
        + batch
    counts = rec["collectives"]["counts"]
    padded = tp_heads(cfg, 0, axes["model"]).split == "padded"
    assert ("all_to_all_single" in counts) == padded


def test_padded_head_blocks_at_the_production_model_degree():
    """At a model degree of 16: starcoder2-7b's 36 heads in blocks of 3
    (ranks 12 to 15 hold none), each rank's 3 heads inside one KV group
    of 9; minitron-4b's 24 in blocks of 2, across a group of 3 on some
    ranks (one KV head a query head); glm4-9b on the ``kv_part`` split."""
    sc = get_config("starcoder2-7b")
    blocks = [tp_heads(sc, m, 16) for m in range(16)]
    assert [t.n for t in blocks] == [3] * 12 + [0] * 4
    assert all(t.split == "padded" for t in blocks)
    assert [t.kv for t in blocks[:4]] == [(0,), (0,), (0,), (1,)]
    mt = get_config("minitron-4b")
    assert tp_heads(mt, 1, 16).kv == (0, 1)
    assert tp_heads(mt, 0, 16).kv == (0,)
    assert tp_heads(get_config("glm4-9b"), 5, 16).split == "kv_part"
    mg = get_config("musicgen-medium")
    assert [tp_heads(mg, m, 16).n for m in range(16)] == [2] * 12 + [0] * 4


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-vl-2b"])
def test_a_rank_with_no_head_runs_rank_0s_collectives(arch):
    """Rank 12 of the 16x16 grid holds no head of the padded split: its
    train step runs rank 0's collectives, in rank 0's order and at its
    sizes, but for the all-to-alls' (each moves its rank's columns), the
    backward's included."""
    cfg = get_config(arch).scaled(n_layers=2)
    assert tp_heads(cfg, 12, 16).n == 0 < tp_heads(cfg, 0, 16).n
    logs = [dryrun.record_cell(arch, "train_4k", False,
                               overrides={"n_layers": 2},
                               rank=r)[0].log.schedule() for r in (0, 12)]
    assert [c[:2] for c in logs[1]] == [c[:2] for c in logs[0]]
    assert [c[:3] for c in logs[1] if c[0] != "all_to_all_single"] == \
        [c[:3] for c in logs[0] if c[0] != "all_to_all_single"]
    # forward and recomputed, and backward: the output's and dq, dk, dv's
    assert sum(c[0] == "all_to_all_single" for c in logs[1]) == \
        cfg.n_layers * cfg.grad_accum * 5


def test_dryrun_list_matches_jax(capsys):
    from repro.launch import dryrun as jax_dryrun

    dryrun.main(["--list"])
    want = [f"{a} {s} {'2x16x16' if mp else '16x16'}"
            for a, s, mp in jax_dryrun.cell_list()]
    assert capsys.readouterr().out.splitlines() == want


def test_cli_writes_an_ok_record(tmp_path, capsys):
    dryrun.main(["--arch", ARCH, "--shape", "train_4k", "--set",
                 "n_layers=1", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / f"{ARCH}__train_4k__16x16__baseline.json"
                      ).read_text())
    assert rec["ok"] and rec["n_layers"] == 1
    assert capsys.readouterr().out.startswith(f"[OK] {ARCH}__train_4k")


def _hand_made_cell():
    def coll(op, numel, moved, source, dtype="bfloat16"):
        return Collective(op=op, dtype=dtype, numel=numel, ranks=(0, 1),
                          moved=moved, shape=(numel,), source=source)

    log = StepLog(collectives=(
        coll("all_gather_into_tensor", 8, 16, "layer 0.0.attn.wq"),
        coll("all_gather_into_tensor", 8, 16, "layer 0.0.attn.wq"),
        coll("all_reduce", 4, 16, "layer 0.0 mlp g", "float32"),
        coll("reduce_scatter_tensor", 8, 32, "layer 0.0.mlp.w_up"),
        coll("reduce_scatter_tensor", 8, 32, "layer 0.1.mlp.w_up"),
        coll("all_reduce", 1, 8, "", "float32")))
    cost = StepCost(traffic={("mm", "layer 0.0"): [100, 4],
                             ("mm", "layer 0.1"): [100, 4],
                             ("flash_attention", "layer 0.0"): [300, 1],
                             ("add", ""): [50, 10]})
    return dryrun.RecordedCell(log=log, cost=cost, arg_bytes=0,
                               out_bytes=0, alias_bytes=0)


def test_analyzer_tables_on_a_hand_made_log():
    cell = _hand_made_cell()
    assert analyze.top_collectives(cell) == [
        (64, 2, ("reduce_scatter_tensor", "bfloat16[8]",
                 "layer 0.*.mlp.w_up")),
        (32, 2, ("all_gather_into_tensor", "bfloat16[8]",
                 "layer 0.*.attn.wq")),
        (16, 1, ("all_reduce", "float32[4]", "layer 0.* mlp g")),
        (8, 1, ("all_reduce", "float32[1]", "?"))]
    assert analyze.top_collectives(cell, 1)[0][0] == 64
    assert analyze.top_buffers(cell) == [
        (300, 1, ("flash_attention", "layer 0.*")),
        (200, 8, ("mm", "layer 0.*")), (50, 10, ("add", "add"))]


def test_analyze_prints_both_tables(capsys):
    analyze.main(["--arch", ARCH, "--shape", "train_4k", "--set",
                  "n_layers=1", "--top", "4"])
    out = capsys.readouterr().out.splitlines()
    i = out.index("== top collectives (bytes moved x trips) ==")
    j = out.index("== top HBM traffic contributors ==")
    assert j - i - 2 == 4 and len(out) - j - 1 == 4
    assert all(" GiB x" in line for line in out[i + 1:j - 1] + out[j + 1:])
