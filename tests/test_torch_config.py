"""The port's ``from_flags`` against the JAX package's: the flags of
``run_scripts/IFSeg/{ade,coco_unseen}.sh`` + ``common.sh`` give the same
value in every field the port's config has, section by section, and the
leaves the model and task sections share stay equal.
"""

import dataclasses
import json
import re
import shlex
from pathlib import Path

import pytest

from ifseg_torch import config as tconf
from ifseg_tpu import config as jconf
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

REPO = Path(__file__).resolve().parents[1]


def _script_argv(name: str):
    """The argument list common.sh passes for run script ``name``, with the
    scripts' defaults for their variables (PARITY=1)."""
    run = (REPO / "run_scripts" / "IFSeg" / f"{name}.sh").read_text()
    common = (REPO / "run_scripts" / "IFSeg" / "common.sh").read_text()
    env = dict(re.findall(r"^export (\w+)='?([^'\n]*)'?$", run, re.M))
    env.update(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}", common, re.M))
    env.update(activation_fn="gelu", session_name=env.get("session_name", name))
    env["save_path"] = f"{env['log_root']}/{env['session_name']}"
    env["data_dir"] = "./dataset/ade"
    call = common[common.index("python -m ifseg_tpu.cli.train"):]
    call = call[:call.index('"$@"')].replace("\\\n", " ")
    call = re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)], call)
    return shlex.split(call)[3:]


@pytest.mark.parametrize("name", ["ade", "coco_unseen"])
def test_run_script_flags_parse_as_in_jax(name):
    argv = _script_argv(name)
    assert any(a.startswith("--category-list=") for a in argv) and "--resnet-iters=25" in argv
    got, want = tconf.from_flags(argv), jconf.from_flags(argv)
    for section in dataclasses.fields(tconf.Config):
        g, w = getattr(got, section.name), getattr(want, section.name)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), f"{section.name}.{f.name}"
    assert got.model.num_seg_tokens == got.task.num_seg_tokens == len(got.task.categories)
    assert got.criterion.resnet_topk == 3 and got.model.activation_fn == "gelu"


def test_defaults_equal_jax():
    for section in dataclasses.fields(tconf.Config):
        g = section.default_factory()
        w = getattr(jconf.Config(), section.name)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), f"{section.name}.{f.name}"


def test_shared_leaves_follow_either_section_and_unknown_flags_are_ignored(tmp_path):
    argv = ["a.tsv,b.tsv", "--num-seg-tokens=7", "--patch-image-size=384", "--no-such-flag=3",
            "--adam-betas=(0.9,0.98)", "--freeze-resnet", "--fixed-validation-seed=3"]
    got, want = tconf.from_flags(argv), jconf.from_flags(argv)
    assert got.model.num_seg_tokens == got.task.num_seg_tokens == want.task.num_seg_tokens == 7
    assert got.model.patch_image_size == got.task.patch_image_size == 384
    assert got.task.data == want.task.data == "a.tsv,b.tsv"
    assert got.optimization.adam_betas == want.optimization.adam_betas == (0.9, 0.98)
    assert got.model.freeze_resnet is True
    flags = tmp_path / "flags.json"
    flags.write_text(json.dumps({"data": "c.tsv", "batch-size-valid": 8, "resnet-iters": 25}))
    cfg = tconf.from_flags([f"--config={flags}", "--arch=segofa_huge"])
    assert (cfg.task.data, cfg.optimization.batch_size_valid, cfg.criterion.resnet_iters,
            cfg.model.encoder_embed_dim) == ("c.tsv", 8, 25, 1280)
    with pytest.raises(ValueError, match="bool"):
        tconf.from_flags(["--freeze-resnet=maybe"])


def test_option_flags_reach_the_port_config_with_the_jax_values():
    """The sibling of the case above: flags the port once dropped because its
    config had no field for them now land in it, as in the JAX package."""
    argv = ["--bitfit", "--encoder-prompt", "--encoder-prompt-length=50", "--no-such-flag=1"]
    got, want = tconf.from_flags(argv), jconf.from_flags(argv)
    assert (got.model.bitfit, got.model.encoder_prompt, got.model.encoder_prompt_length) == (
        want.model.bitfit, want.model.encoder_prompt, want.model.encoder_prompt_length) == (
        True, True, 50)
    assert got.model.decoder_prompt is want.model.decoder_prompt is False
