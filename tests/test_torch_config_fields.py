"""Every field of every section of the JAX package's ``Config`` exists in
the port's with the same default (one case a field), so a flag means the
same thing in both; the option flags this port honours parse to the JAX
values; the process and mesh fields and the cross-process sanitizers parse
to the JAX values and reach what reads them (one case a field), the
pipeline, context and expert fields too (ROADMAP.md A.9b, ported since
with the model axis's programs).
"""

import dataclasses

import pytest

from ifseg_torch import config as tconf
from ifseg_tpu import config as jconf

FIELDS = [(section.name, f.name) for section in dataclasses.fields(jconf.Config)
          for f in dataclasses.fields(section.default_factory())]
# the fields ported with the process layout and the model axis's programs,
# with a value each
PORTED = {("common", "check_grad_consistency"): "false",
          ("common", "check_param_sync_interval"): "10",
          **{("distributed", name): value for name, value in dict(
              data_parallel="1", tensor_parallel="2", fsdp="2", zero1="true",
              coordinator_address="localhost:1234", num_processes="2",
              process_id="1", pipeline_parallel="2", pipeline_chunks="4",
              context_parallel="2", moe_experts="4", moe_freq="3",
              moe_assignment="auction").items()}}


def test_the_unported_list_covers_the_distributed_section():
    # every field of the section is ported and held in PORTED
    assert {n for s, n in PORTED if s == "distributed"} == {
        f.name for f in dataclasses.fields(jconf.DistributedConfig)}


@pytest.mark.parametrize("section,name", FIELDS, ids=[f"{s}.{n}" for s, n in FIELDS])
def test_jax_field_has_a_port_counterpart_with_its_default(section, name):
    got = getattr(getattr(tconf.Config(), section), name)
    want = getattr(getattr(jconf.Config(), section), name)
    assert got == want and type(got) is type(want)


def test_option_flags_parse_as_in_jax():
    argv = ["--bitfit", "--encoder-prompt", "--encoder-prompt-type=prefix",
            "--encoder-prompt-length=64", "--encoder-prompt-projection",
            "--encoder-prompt-dim=512", "--decoder-prompt=true", "--decoder-prompt-length=32",
            "--decoder-prompt-projection=false", "--decoder-prompt-dim=0", "--adapter",
            "--adapter-dim=128", "--activation-fn=gelu_poly", "--use-flash-attention=false",
            "--resnet-drop-path-rate=0.2", "--sentence-avg", "--max-src-length=64",
            "--fixed-validation-seed=3", "--profile", "--log-file=x.log"]
    got, want = tconf.from_flags(argv), jconf.from_flags(argv)
    for section, name in FIELDS:
        assert getattr(getattr(got, section), name) == getattr(getattr(want, section), name), (
            section, name)
    m = got.model
    assert (m.bitfit, m.encoder_prompt, m.encoder_prompt_length, m.decoder_prompt_length,
            m.adapter_dim, m.activation_fn, m.use_flash_attention) == (
        True, True, 64, 32, 128, "gelu_poly", False)


def _honoured(cfg, name, monkeypatch):
    """What the port makes of the field: the value its reader sees."""
    from ifseg_torch.cli import train
    from ifseg_torch.parallel.mesh import MeshConfig, mesh_shape, model_axis_size
    from ifseg_torch.train.trainer import configured_strategies

    d = cfg.distributed
    if name in ("coordinator_address", "num_processes", "process_id"):
        seen = {}
        monkeypatch.setattr(train, "initialize_distributed",
                            lambda *args, **kw: seen.update(args=args))
        monkeypatch.setattr(train, "mesh_from_config", lambda *args: None)
        train.start_processes(cfg, device="cpu")
        return seen["args"][("coordinator_address", "num_processes", "process_id").index(name)]
    if name == "data_parallel":
        return mesh_shape(MeshConfig(d.data_parallel, d.fsdp, d.tensor_parallel), 1)[0]
    if name == "tensor_parallel":
        return "tp" in configured_strategies(d) and model_axis_size(d)
    if name == "fsdp":
        return "fsdp" in configured_strategies(d) and mesh_shape(
            MeshConfig(-1, d.fsdp, 1), 4)[1]
    if name == "zero1":
        return "zero1" in configured_strategies(d)
    if name in A9B_READERS:
        from ifseg_torch.parallel.mesh import ProcessMesh
        from ifseg_torch.parallel.plan import plan_from_config

        # a field of a program, with the program it belongs to switched on
        for key, value in A9B_WITH[name].items():
            setattr(d, key, value)
        plan = plan_from_config(d, ProcessMesh((1, 1, model_axis_size(d)), 0, join=False))
        return A9B_READERS[name](plan)
    if name == "check_grad_consistency":
        return train.sanitizers_due(cfg, 7)[0]
    if name == "check_param_sync_interval":
        return (train.sanitizers_due(cfg, 20)[1], train.sanitizers_due(cfg, 25)[1])
    raise KeyError(name)


def _moe_layers(plan):
    from ifseg_torch.models.layers import moe_layer

    return tuple(i for i in range(6) if moe_layer(plan, i))


def _assignment(plan):
    from ifseg_torch.parallel.moe import ASSIGNMENTS

    return ASSIGNMENTS[plan.moe_assignment].__name__


# the readers of the model axis's fields (the plan the trainer and the
# model take; which layers hold experts; the assignment the layer calls)
A9B_READERS = {"pipeline_parallel": lambda p: p.pipeline_parallel,
               "pipeline_chunks": lambda p: p.chunks,
               "context_parallel": lambda p: p.context_parallel,
               "moe_experts": lambda p: (p.moe_experts, _moe_layers(p)),
               "moe_freq": _moe_layers, "moe_assignment": _assignment}
A9B_WITH = {"pipeline_parallel": {}, "pipeline_chunks": dict(pipeline_parallel=2),
            "context_parallel": {}, "moe_experts": {}, "moe_freq": dict(moe_experts=2),
            "moe_assignment": dict(moe_experts=2)}

HONOURED = {"check_grad_consistency": False, "check_param_sync_interval": (True, False),
            "data_parallel": 1, "tensor_parallel": 2, "fsdp": 2, "zero1": True,
            "coordinator_address": "localhost:1234", "num_processes": 2, "process_id": 1,
            "pipeline_parallel": 2, "pipeline_chunks": 4, "context_parallel": 2,
            "moe_experts": (4, (1, 3, 5)), "moe_freq": (2, 5),
            "moe_assignment": "balanced_assignment_auction"}


@pytest.mark.parametrize("section,name", sorted(PORTED), ids=[f"{s}.{n}" for s, n in
                                                               sorted(PORTED)])
def test_ported_field_parses_as_in_jax_and_is_honoured(section, name, monkeypatch):
    flag = f"--{name.replace('_', '-')}={PORTED[(section, name)]}"
    got = getattr(getattr(tconf.from_flags([flag]), section), name)
    assert got == getattr(getattr(jconf.from_flags([flag]), section), name)
    assert _honoured(tconf.from_flags([flag]), name, monkeypatch) == HONOURED[name]
