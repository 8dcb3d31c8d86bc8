"""Evaluation-only entry point (the fairseq_cli/validate.py analog).

Runs native-resolution mIoU evaluation over a TSV with a saved checkpoint,
on the card unless ``--device=cpu`` is given:

  python -m ifseg_torch.cli.validate $data --arch=segofa_base \\
      --num-seg-tokens=150 --category-list='wall, ...' \\
      --restore-file=ofa_base.pt [--resnet-topk=3 --resnet-iters=25] \\
      [--batch-size-valid=8] [--device=cpu]

The port of the JAX package's ``cli/validate.py``: the same flags, the same
steps (task, dataset, weights, ``Evaluator.eval_dataset``, the task's metric
reduction) and the same ``vals``.  The weights come from a fairseq ``.pt``
file or a checkpoint directory of ``cli.train`` such as
``<save_dir>/checkpoint_best`` (``checkpoint/convert.py:load_model``; under
``--uses-ema`` its EMA weights).
"""

import logging
import sys
import time
from typing import List, Optional, Union

import torch

from ifseg_torch.checkpoint.convert import load_model
from ifseg_torch.config import Config, from_flags
from ifseg_torch.eval.evaluator import Evaluator
from ifseg_torch.tasks.segmentation import SegmentationTask
from ifseg_torch.utils import metrics as metrics_lib

logger = logging.getLogger("ifseg_torch.validate")


def main(cfg: Config, device: Optional[Union[str, torch.device]] = None,
         logs_out: Optional[list] = None) -> dict:
    """Validate ``cfg.checkpoint.restore_file`` on the last TSV of
    ``cfg.task.data`` and return the smoothed meters (``loss``,
    ``nll_loss``, ``aAcc``, ``mIoU``, ``mAcc`` and their
    ``_resnet_postprocess`` variants when label propagation is on) with
    ``num_images`` and ``sec``.  ``device=None`` means ``"cuda"`` and raises
    when no card is present.  ``logs_out``, when given, receives the
    per-group logs (summed areas and CE) the meters were reduced from."""
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("validate: no CUDA device (pass device='cpu' to run on the CPU)")
    task = SegmentationTask.setup_task(cfg)
    ds = task.load_dataset("valid")
    model = load_model(cfg.checkpoint.restore_file, cfg.model, ema=cfg.task.uses_ema)
    evaluator = Evaluator(cfg, model, device=device)

    metrics_lib.reset_meters("validate")
    with metrics_lib.aggregate("validate", new_root=True) as agg:
        t0 = time.time()
        # --batch-size-valid groups same-bucket rows into one padded forward;
        # host decoding overlaps the device's work
        logs = evaluator.eval_dataset(ds, batch_size=max(cfg.optimization.batch_size_valid, 1))
        task.reduce_metrics(logs)
        if logs_out is not None:
            logs_out.extend(logs)
        vals = agg.get_smoothed_values()
        vals["num_images"] = len(ds)
        vals["sec"] = round(time.time() - t0, 1)
    logger.info("validate: %s", " | ".join(f"{k} {v}" for k, v in vals.items()))
    return vals


def cli_main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for tok in [t for t in argv if t.startswith("--device=")]:
        device = tok.split("=", 1)[1]
        argv.remove(tok)
    main(from_flags(argv), device=device)


if __name__ == "__main__":
    cli_main()
