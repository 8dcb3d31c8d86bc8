"""``ifseg_torch.cli.validate`` end to end on the CPU, against the JAX
package's ``cli/validate.py``: the same TSV, the same flags, the same
weights in a fairseq ``.pt`` file written by the JAX package's
``flax_to_torch_state_dict`` (complete, so neither side backfills anything).

Rows that need no bucket padding (256 x 256 at ``patch_image_size`` 256)
go through both CLIs whole: the per-class areas must be equal and the
unrounded loss agree to 1e-5 relative (fp32 on both sides, the same
arithmetic in another order).  Padded rows meet the JAX evaluator's uint8
pad hazard (``ROADMAP.md`` C.4: it normalizes the zero pad to -mean/std),
so there the port's CLI is held against the JAX ``Evaluator`` fed the JAX
dataset's rows normalized on the host in fp32, as
``tests/test_torch_evaluator.py`` does, under that file's 1e-3.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import ifseg_torch.cli.validate as tval
import ifseg_tpu.cli.validate as jval
from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.utils import metrics as tmetrics
from ifseg_tpu.checkpoint.convert import flax_to_torch_state_dict
from ifseg_tpu.cli.infer import load_params
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.data.segmentation_dataset import EvalSample as JaxSample
from ifseg_tpu.data.segmentation_dataset import eval_mean_std
from ifseg_tpu.eval.evaluator import Evaluator as JaxEvaluator
from ifseg_tpu.models.segofa import SegOFAVariables
from ifseg_tpu.tasks.segmentation import SegmentationTask as JaxTask
from ifseg_tpu.utils import metrics as jmetrics

from torch_port_utils import TINY, perturb
from utils import make_seg_tsv

AREAS = ("_area_intersect", "_area_pred_label", "_area_label", "_area_union")
POST = tuple(a + "_resnet_postprocess" for a in AREAS)


def _argv(tsv, ckpt, bpe_dir, size):
    dims = {k: v for k, v in TINY.items()
            if k not in ("patch_image_size", "orig_patch_image_size", "num_seg_tokens")}
    return [tsv, "--arch=segofa_tiny", *(f"--{k.replace('_', '-')}={v}" for k, v in dims.items()),
            "--num-seg-tokens=3", "--category-list=cat, dog, grass",
            f"--patch-image-size={size}", f"--orig-patch-image-size={size}",
            f"--bpe-dir={bpe_dir}", f"--restore-file={ckpt}", "--batch-size-valid=4",
            "--resnet-topk=2", "--resnet-iters=2"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, bpe_dir):
    """A complete .pt file of perturbed JAX weights at the tiny width."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    jcfg = jax_flags(_argv("x.tsv", path, bpe_dir, 256))
    _, params = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(3))
    sd = flax_to_torch_state_dict(perturb(params, 3))
    # the port holds the reference decoder's image position table, which no
    # path reads and the JAX model does not create
    rows, dim = sd["encoder.embed_image_positions.weight"].shape
    sd["decoder.embed_image_positions.weight"] = np.zeros((rows, dim), np.float32)
    torch.save({"model": {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}},
               path)
    return path


def _meters(lib):
    agg = {k: lib.get_meter("validate", k) for k in ("loss",) + AREAS + POST}
    return {k: (m.avg if k == "loss" else np.asarray(m.sum)) for k, m in agg.items()}


def test_validate_matches_jax_on_unpadded_rows(tmp_path, bpe_dir, checkpoint, monkeypatch, caplog):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")  # leave the tests' JAX cache alone
    tsv = make_seg_tsv(str(tmp_path / "valid.tsv"), rows=5, num_seg=3, size=(256, 256), seed=4)
    argv = _argv(tsv, checkpoint, bpe_dir, 256)
    with caplog.at_level(logging.INFO, logger="ifseg_torch.checkpoint.convert"):
        logs = []
        got = tval.main(torch_flags(argv), device="cpu", logs_out=logs)
    assert not [r for r in caplog.records if r.name == "ifseg_torch.checkpoint.convert"]
    got_m = _meters(tmetrics)
    for k in AREAS + POST:  # the group logs handed out are the ones the meters summed
        assert np.array_equal(sum(lg[k[1:]] for lg in logs), got_m[k]), k
    want = jval.main(jax_flags(argv))
    want_m = _meters(jmetrics)

    assert set(got) == set(want) and got["num_images"] == want["num_images"] == 5
    for k in AREAS + POST:
        assert np.array_equal(got_m[k], want_m[k]), k
    for k in ("mIoU", "aAcc", "mAcc", "mIoU_resnet_postprocess", "aAcc_resnet_postprocess",
              "mAcc_resnet_postprocess"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-5)
    assert got["loss"] == got["nll_loss"]


def test_validate_padded_rows_match_jax_on_normalized_rows(tmp_path, bpe_dir, checkpoint):
    """200 x 240 rows resize to 256 x 307: padded into the (256, 512) bucket."""
    tsv = make_seg_tsv(str(tmp_path / "valid.tsv"), rows=3, num_seg=3, size=(200, 240), seed=5)
    argv = _argv(tsv, checkpoint, bpe_dir, 256)
    got = tval.main(torch_flags(argv), device="cpu")
    got_m = _meters(tmetrics)

    jcfg = jax_flags(argv)
    task = JaxTask.setup_task(jcfg)
    ds = task.load_dataset("valid")
    mean, std = (np.asarray(v, np.float32) for v in eval_mean_std(jcfg.task))

    class Normalized:
        def __len__(self):
            return len(ds)

        def get_eval_sample(self, i):
            s = ds.get_eval_sample(i)
            assert s.patch_image.shape[:2] == (256, 307)
            img = (s.patch_image.astype(np.float32) / 255.0 - mean) / std
            return JaxSample(img, s.src_tokens, s.bos_token, s.ori_semantic_seg, s.ori_shape, s.id)

    params = load_params(jcfg.checkpoint.restore_file, jcfg)
    jmodel, _ = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(0))
    logs = JaxEvaluator(jcfg, jmodel).eval_dataset(params, Normalized(), batch_size=4)
    jmetrics.reset_meters("validate")
    with jmetrics.aggregate("validate", new_root=True):
        task.reduce_metrics(logs)
    want_m = _meters(jmetrics)
    for k in AREAS + POST:
        assert np.array_equal(got_m[k], want_m[k]), k
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-3)
    assert got["num_images"] == 3


def test_validate_runs_on_the_card_unless_told_otherwise(tmp_path, bpe_dir, checkpoint):
    """Without a card and without ``device``, ``main`` raises before it
    reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run on it")
    tsv = make_seg_tsv(str(tmp_path / "valid.tsv"), rows=1, num_seg=3, size=(64, 64), seed=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.main(torch_flags(_argv(tsv, checkpoint, bpe_dir, 256)))


def test_cli_main_reads_the_device_flag(monkeypatch):
    """``--device=`` goes to ``main``; every other flag to ``from_flags``."""
    seen = {}
    monkeypatch.setattr(tval, "main", lambda cfg, device=None: seen.update(cfg=cfg, device=device))
    tval.cli_main(["x.tsv", "--device=cpu", "--batch-size-valid=8", "--num-seg-tokens=3"])
    cfg = seen["cfg"]
    assert seen["device"] == "cpu" and cfg.task.data == "x.tsv"
    assert cfg.optimization.batch_size_valid == 8 and cfg.model.num_seg_tokens == 3
    tval.cli_main(["x.tsv"])
    assert seen["device"] is None
