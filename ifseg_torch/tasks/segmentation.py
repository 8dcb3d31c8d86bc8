"""Segmentation task: dictionary, BPE, datasets, metric reduction.

A copy of the JAX package's ``tasks/segmentation.py`` (tasks/mm_tasks/segmentation.py
+ tasks/ofa_task.py of the reference):
  - ``setup_task`` builds the dictionary with <mask>/<code_i>/<bin_i>/<seg_i>
    symbols (segmentation.py:109-136) and the GPT-2 BPE (ofa_task.py:167-185)
  - ``load_dataset`` reads the TSV (train = paths[(epoch-1) % (len-1)],
    valid = last; segmentation.py:139-155) with the epoch row cap
  - ``get_batch_iterator`` replicates the custom sequential sampler
    (ofa_task.py:120-165): contiguous batches, no shuffling
  - ``reduce_metrics`` aggregates per-class areas into mIoU/aAcc/mAcc meters
    (segmentation.py:231-264, seg_criterion.py:415-572)
"""

import logging
import os
from typing import Dict, List

import numpy as np

from ifseg_torch.config import Config, TaskConfig
from ifseg_torch.data.file_dataset import FileDataset
from ifseg_torch.data.iterators import EpochBatchIterator
from ifseg_torch.data.segmentation_dataset import SegmentationDataset
from ifseg_torch.tokenization.bert_bpe import BertBPE
from ifseg_torch.tokenization.dictionary import Dictionary, build_seg_dictionary
from ifseg_torch.tokenization.gpt2_bpe import GPT2BPE
from ifseg_torch.utils import metrics as metrics_lib

logger = logging.getLogger(__name__)


class SegmentationTask:
    def __init__(self, cfg: TaskConfig, dictionary: Dictionary, bpe):
        self.cfg = cfg
        self.dict = dictionary
        self.bpe = bpe
        self.datasets: Dict[str, SegmentationDataset] = {}
        # (slice id, slice count): the contiguous part of each TSV this
        # process reads (its data x fsdp rank among the ranks that split the
        # batch, ref file_dataset.py:40-45)
        self.data_slice = (0, 1)

    @classmethod
    def setup_task(cls, cfg) -> "SegmentationTask":
        task_cfg = cfg.task if isinstance(cfg, Config) else cfg
        dictionary = build_seg_dictionary(
            task_cfg.bpe_dir,
            code_dict_size=task_cfg.code_dict_size,
            num_bins=task_cfg.num_bins,
            num_seg_tokens=task_cfg.num_seg_tokens,
        )
        bpe_name = getattr(task_cfg, "bpe", "gpt2")
        if bpe_name == "bert":
            # OFA-CN: WordPiece over vocab.txt in the bpe dir; the dictionary
            # (dict.txt alongside it) maps token strings to ids
            # (reference tasks/ofa_task.py:169-176).
            bpe = BertBPE(os.path.join(task_cfg.bpe_dir, "vocab.txt"))
        elif bpe_name == "gpt2":
            bpe = GPT2BPE.from_dir(task_cfg.bpe_dir)
        else:
            raise ValueError(f"unknown --bpe={bpe_name!r} (expected 'gpt2' or 'bert')")
        logger.info("dictionary: %d types", len(dictionary))
        return cls(task_cfg, dictionary, bpe)

    # ------------------------------------------------------------------- data

    def load_dataset(self, split: str, epoch: int = 1) -> SegmentationDataset:
        paths = [p for p in self.cfg.data.split(",") if p]
        if not paths:
            raise ValueError("task.data is empty: give the TSV path(s)")
        if split == "train" and len(paths) > 1:
            table_path = paths[(epoch - 1) % (len(paths) - 1)]
        else:
            table_path = paths[-1]
        file_ds = FileDataset(table_path, self.cfg.selected_cols, slice_id=self.data_slice[0],
                              slice_count=self.data_slice[1])
        if split == "train" and self.cfg.epoch_row_count > -1:
            logger.info("epoch row count -> %d", self.cfg.epoch_row_count)
            file_ds.set_total_row_count(self.cfg.epoch_row_count)
        ds = SegmentationDataset(split, file_ds, self.bpe, self.dict, self.cfg)
        self.datasets[split] = ds
        return ds

    def get_batch_iterator(self, split: str, batch_size: int, seed: int = 1,
                           epoch: int = 1) -> EpochBatchIterator:
        """Training batches (``SegBatch``es, the task's ``num_workers``
        threads building their rows).  Only the train split has one: the
        evaluation rows go through ``Evaluator.eval_dataset``."""
        if split != "train":
            raise ValueError(f"get_batch_iterator: only the train split has batches, not {split!r} "
                             "(evaluation rows go through Evaluator.eval_dataset)")
        ds = self.datasets[split]
        return EpochBatchIterator(
            num_rows=len(ds),
            batch_size=batch_size,
            make_example=ds.get_train_example,
            collate=ds.collate_train,
            seed=seed,
            epoch=epoch,
            num_workers=self.cfg.num_workers,
            row_offset=ds.dataset.start_pos,
        )

    # ---------------------------------------------------------------- metrics

    @staticmethod
    def reduce_metrics(logging_outputs: List[Dict], sample_size: float = 1.0) -> None:
        """Aggregate per-step logging dicts into the active meters
        (seg_criterion.reduce_metrics :415-572)."""
        if not logging_outputs:
            return
        keys = logging_outputs[0].keys()
        sums = {
            k: sum(np.asarray(log[k]) for log in logging_outputs if k in log)
            for k in keys
        }
        n = len(logging_outputs)
        if "nll_cnt" in sums:
            # native-res eval groups carry summable (nll_sum, nll_cnt): the
            # exactly-weighted mean is invariant to how samples were split
            # into groups (the ratio keys in the logs are per-group
            # conveniences, not summable)
            cnt = float(np.maximum(sums["nll_cnt"], 1.0))
            mean = float(sums["nll_sum"]) / cnt
            metrics_lib.log_scalar("nll_loss", mean, cnt, round=3)
            metrics_lib.log_scalar("loss", mean, cnt, round=3)
        else:
            for k in ("loss", "imfree_loss", "seg_loss", "nll_loss"):
                if k in sums:
                    metrics_lib.log_scalar(k, sums[k] / n, n, round=3)
        if "gnorm" in sums:
            metrics_lib.log_scalar("gnorm", sums["gnorm"] / n, n, round=3)
        if "n_nonfinite" in sums:
            metrics_lib.log_scalar_sum("n_nonfinite", sums["n_nonfinite"])
        for suffix in ("", "_lowres", "_resnet_postprocess", "_infer"):
            base = f"area_intersect{suffix}"
            if base in sums:
                metrics_lib.log_seg_areas(
                    (
                        sums[f"area_intersect{suffix}"],
                        sums[f"area_pred_label{suffix}"],
                        sums[f"area_label{suffix}"],
                        sums[f"area_union{suffix}"],
                    ),
                    suffix.lstrip("_"),
                )
