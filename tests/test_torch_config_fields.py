"""Every field of every section of the JAX package's ``Config`` exists in
the port's with the same default (one case a field), so a flag means the
same thing in both; the option flags this port honours parse to the JAX
values; the process and mesh fields and the cross-process sanitizers parse
to the JAX values and reach what reads them (one case a field); the fields
the JAX package honours and the port does not yet (the pipeline, context
and expert fields of the ``distributed`` section, ROADMAP.md A.9b) raise at
a value off their default.
"""

import dataclasses

import pytest

from ifseg_torch import config as tconf
from ifseg_tpu import config as jconf

FIELDS = [(section.name, f.name) for section in dataclasses.fields(jconf.Config)
          for f in dataclasses.fields(section.default_factory())]
# the fields the port refuses off their default (ROADMAP.md A.9b), with a value each
UNPORTED = {("distributed", name): value for name, value in dict(
    pipeline_parallel="2", pipeline_chunks="4", context_parallel="2", moe_experts="4",
    moe_freq="3", moe_assignment="auction").items()}
# the fields ported with the process layout, with a value each
PORTED = {("common", "check_grad_consistency"): "false",
          ("common", "check_param_sync_interval"): "10",
          **{("distributed", name): value for name, value in dict(
              data_parallel="1", tensor_parallel="2", fsdp="2", zero1="true",
              coordinator_address="localhost:1234", num_processes="2",
              process_id="1").items()}}


def test_the_unported_list_covers_the_distributed_section():
    assert {n for s, n in {**UNPORTED, **PORTED} if s == "distributed"} == {
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


@pytest.mark.parametrize("section,name", sorted(UNPORTED), ids=[f"{s}.{n}" for s, n in
                                                                 sorted(UNPORTED)])
def test_unported_field_raises_off_its_default(section, name):
    value = UNPORTED[(section, name)]
    flag = f"--{name.replace('_', '-')}={value}"
    jconf.from_flags([flag])  # the JAX package takes it
    with pytest.raises(NotImplementedError, match="A.9b"):
        tconf.from_flags([flag])
    # at the default, nothing raises
    default = getattr(getattr(jconf.Config(), section), name)
    if default is not None:
        tconf.from_flags([f"--{name.replace('_', '-')}={default}"])


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
    if name == "check_grad_consistency":
        return train.sanitizers_due(cfg, 7)[0]
    if name == "check_param_sync_interval":
        return (train.sanitizers_due(cfg, 20)[1], train.sanitizers_due(cfg, 25)[1])
    raise KeyError(name)


HONOURED = {"check_grad_consistency": False, "check_param_sync_interval": (True, False),
            "data_parallel": 1, "tensor_parallel": 2, "fsdp": 2, "zero1": True,
            "coordinator_address": "localhost:1234", "num_processes": 2, "process_id": 1}


@pytest.mark.parametrize("section,name", sorted(PORTED), ids=[f"{s}.{n}" for s, n in
                                                               sorted(PORTED)])
def test_ported_field_parses_as_in_jax_and_is_honoured(section, name, monkeypatch):
    flag = f"--{name.replace('_', '-')}={PORTED[(section, name)]}"
    got = getattr(getattr(tconf.from_flags([flag]), section), name)
    assert got == getattr(getattr(jconf.from_flags([flag]), section), name)
    assert _honoured(tconf.from_flags([flag]), name, monkeypatch) == HONOURED[name]
