"""Training entry point: the IFSeg recipe from TSV rows to best/last
checkpoints, on the card unless ``--device=cpu`` is given.

    python -m ifseg_torch.cli.train train.tsv,valid.tsv --arch=segofa_base \\
        --num-seg-tokens=150 --category-list='wall, building, ...' \\
        --restore-file=ofa_base.pt --save-dir=ckpt ... [--device=cpu]

The port of the JAX package's ``cli/train.py`` (reference train.py:51-256,
the flags of ``run_scripts/IFSeg/common.sh``): set up the task, build the
trainer, load the pretrained weights (``.pt`` with the vocab surgery, a
fabricated file under ``--dry-weights``, or a checkpoint directory of the
port), restore the newest checkpoint of ``--save-dir`` under the reset
flags, then per epoch: train (the one-batch-ahead fetch, data-wait
accounting, ``--save-interval-updates`` with the iterator's cursor,
``--max-update`` / ``--stop-time-hours``, the log interval, the abort after
``--max-consecutive-nonfinite`` skipped updates), validate at native
resolution through the ``Evaluator`` (the trainer's weights, or its EMA
copy under ``--uses-ema``), save with best-metric rotation, and stop early
under ``--patience``.  The schedule spans ``max_epoch`` times the updates
of an epoch; under ``--lr-scheduler=reduce_lr_on_plateau`` the trainer's
plateau controller steps on each validation's best-checkpoint metric and
sets the lr scale.  ``--encoder/decoder-layers-to-keep`` prune the
pretrained checkpoint before it is loaded.

Several processes (``--num-processes``, ``--coordinator-address``,
``--process-id``, as the JAX CLI takes them; each process is one device,
``cuda:{process_id % cards}`` unless ``--device`` names one, NCCL unless
``--dist-backend=gloo``): the mesh of ``--data-parallel``, ``--fsdp`` and
``--tensor-parallel`` (``--zero1``), or of the model axis's programs in
place of tensor parallelism (``--pipeline-parallel``, ``--pipeline-chunks``,
``--context-parallel``, ``--moe-experts``, ``--moe-freq``,
``--moe-assignment``: the trainer's plan, which its evaluator's model
shares; the pretrained file's missing experts keep their fresh
initialisation), each data x fsdp rank reading its
contiguous slice of every TSV and stepping on ``--batch-size`` / (data x
fsdp) rows of the global batch, the epoch counting the global rows.  Host
barriers stand before the first step and each validation; a heartbeat
(``IFSEG_HEARTBEAT`` seconds, 600 by default) logs a loop that stops making
progress; at each log interval the gradient norms are compared across the
ranks (``--check-grad-consistency``) and every
``--check-param-sync-interval`` updates the parameter fingerprints.  The
stop (``--max-update``, ``--stop-time-hours``, the non-finite streak) is
agreed by all ranks after every step, so they stop after the same update
and save the same cursor.  Validation evaluates each rank's slice of the
valid TSV and sums the areas and CE over the ranks; only rank 0 logs and
writes checkpoints, of the whole state in the one-process layout.

One deliberate difference (ROADMAP.md C.3): a stop on ``--max-update`` or
``--stop-time-hours`` inside an epoch saves a mid-epoch checkpoint with the
cursor, not the JAX package's epoch-complete one, so a resume goes on inside
that epoch; and a resume restores the plateau controller, which the JAX
CLI builds anew.  Not ported: profiling spans (A.10).
"""

import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ifseg_torch.checkpoint.convert import fabricate_ofa_base_checkpoint, load_model
from ifseg_torch.checkpoint.manager import CheckpointManager
from ifseg_torch.config import Config, from_flags
from ifseg_torch.eval.evaluator import Evaluator, reduce_across_ranks
from ifseg_torch.parallel import comm
from ifseg_torch.parallel.mesh import (
    ProcessMesh,
    coordination_barrier,
    default_device,
    initialize_distributed,
    local_batch_slice,
    mesh_from_config,
    shutdown_distributed,
)
from ifseg_torch.tasks.segmentation import SegmentationTask
from ifseg_torch.train.trainer import Trainer
from ifseg_torch.utils import metrics as metrics_lib
from ifseg_torch.utils.progress import progress_bar
from ifseg_torch.utils.reliability import Heartbeat, check_grad_norms, check_param_sync

logger = logging.getLogger("ifseg_torch.train")


def start_processes(cfg: Config, device: Optional[Union[str, torch.device]] = None,
                    backend: Optional[str] = None) -> Tuple[torch.device, ProcessMesh]:
    """(this process's device, the mesh): the process group started from
    the three process flags (nothing for one process), the device
    ``device`` or ``cuda:{process_id % cards}``."""
    d = cfg.distributed
    if device is None:
        device = default_device(d.process_id) if d.num_processes > 1 else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    initialize_distributed(d.coordinator_address, d.num_processes, d.process_id, device, backend)
    return device, mesh_from_config(d, device)


def main(cfg: Config, device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None) -> Dict[str, Any]:
    """Train as ``cfg`` says and return what happened: ``epochs`` (per
    epoch, the smoothed training meters; each step's wall seconds, alone and
    with the fetch of the next batch; each batch's wait on the host
    pipeline; the validation values or None),
    ``num_updates``, ``start_epoch``, ``restored_updates``,
    ``resumed_iterations``, ``restore_s``, ``saves`` (name and seconds of
    each save), ``stop`` (why training ended early, or None), ``best`` and
    ``best_metric``.  ``device=None`` means ``"cuda"`` (``cuda:{process_id
    % cards}`` for several processes) and raises when no card is present;
    ``backend`` names the process group's backend (NCCL for a card by
    default)."""
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    device, mesh = start_processes(cfg, device, backend)
    try:
        return _train(cfg, device, mesh)
    finally:
        if cfg.distributed.num_processes > 1:
            shutdown_distributed()


def _train(cfg: Config, device: torch.device, mesh: ProcessMesh) -> Dict[str, Any]:
    if mesh.rank > 0:  # rank 0 logs for all
        logging.getLogger("ifseg_torch").setLevel(logging.WARNING)
    logger.info("mesh %s over %d processes", mesh.shape, mesh.world)

    # the image-free fast path: with no monitoring forward, no step reads the
    # real images, so the rows are never decoded
    if (cfg.criterion.unsupervised_segmentation and not cfg.criterion.monitor_real_batch
            and cfg.task.artificial_image_type.startswith("rand_k")):
        cfg.task.decode_real_images = False
        logger.info("image-free fast path: real images are never decoded "
                    "(--monitor-real-batch=true to restore the monitoring forward)")

    metrics_lib.reset()
    task = SegmentationTask.setup_task(cfg)
    task.data_slice = (mesh.index("batch"), mesh.size("batch"))
    train_ds = task.load_dataset("train", epoch=1)
    task.load_dataset("valid")

    # total updates for the cosine schedule (ref train.py:176-184), over the
    # rows of every data x fsdp rank
    global_batch = cfg.optimization.batch_size * max(cfg.optimization.update_freq, 1)
    iters_per_epoch = len(train_ds) * mesh.size("batch") // global_batch
    total_updates = cfg.optimization.max_epoch * max(iters_per_epoch, 1)
    logger.info("iters/epoch %d, total updates %d", iters_per_epoch, total_updates)

    trainer = Trainer(cfg, train_ds.class_tokens, train_ds.class_lengths,
                      total_num_updates=total_updates, device=device, mesh=mesh)
    trainer.init_state(maybe_restore_pretrained(cfg, trainer.device, trainer.plan))

    run: Dict[str, Any] = dict(epochs=[], saves=[], stop=None)
    ckpt = CheckpointManager(cfg.checkpoint, writer=mesh.rank == 0)
    t0 = time.perf_counter()
    start_epoch, resume_iter = restore_training_state(cfg, trainer, ckpt)
    run.update(restore_s=time.perf_counter() - t0, start_epoch=start_epoch,
               resumed_iterations=(resume_iter or {}).get("iterations_in_epoch", 0),
               restored_updates=trainer.get_num_updates())
    evaluator = Evaluator(cfg, trainer.eval_model(), device=trainer.device)
    # every rank built and restored before the first collective of a step
    coordination_barrier("cli_train_start", mesh=mesh)

    # early stop (ref train.py should_stop_early :207-233): validations in a
    # row without a better best metric
    es_best: Optional[float] = None
    es_bad = 0
    train_start = time.time()
    for epoch in range(start_epoch, cfg.optimization.max_epoch + 1):
        record: Dict[str, Any] = dict(epoch=epoch, valid=None)
        run["epochs"].append(record)
        hard_stop, completed = train_epoch(
            cfg, task, trainer, epoch, ckpt, record, run["saves"],
            resume_iter=resume_iter if epoch == start_epoch else None, train_start=train_start)
        if trainer.device.type == "cuda":
            logger.info("peak device memory: %.2f GiB",
                        torch.cuda.max_memory_allocated(trainer.device) / 2**30)
        metric = None
        if epoch % max(cfg.checkpoint.validate_interval, 1) == 0 or hard_stop:
            record["valid"] = validate(cfg, task, trainer, epoch, evaluator)
            metric = record["valid"].get(cfg.checkpoint.best_checkpoint_metric)
        if trainer.plateau is not None and metric is not None:
            record["lr_scale"] = trainer.plateau.step(float(metric))
            trainer.set_lr_scale(record["lr_scale"])
            logger.info("plateau lr scale: %s", record["lr_scale"])
        if completed and (epoch % cfg.checkpoint.save_interval == 0 or hard_stop):
            _save(ckpt, run["saves"], epoch, trainer,
                  extra={"epoch": epoch, "metrics": metrics_lib.state_dict()}, val_metric=metric)
        if hard_stop:
            logger.info("stopping: %s", hard_stop)
            run["stop"] = hard_stop
            break
        # patience: skip the check when no validation ran this epoch
        if cfg.checkpoint.patience > 0 and metric is not None:
            maximize = cfg.checkpoint.maximize_best_checkpoint_metric
            if es_best is None or (float(metric) > es_best if maximize
                                   else float(metric) < es_best):
                es_best, es_bad = float(metric), 0
            else:
                es_bad += 1
                if es_bad >= cfg.checkpoint.patience:
                    logger.info("early stop: %s has not improved for %d validations",
                                cfg.checkpoint.best_checkpoint_metric, es_bad)
                    run["stop"] = "patience"
                    break
    ckpt.finalize()
    logger.info("done training; best %s=%s", cfg.checkpoint.best_checkpoint_metric,
                ckpt.manifest.get("best_metric"))
    run.update(num_updates=trainer.get_num_updates(), best=ckpt.best(),
               best_metric=ckpt.manifest.get("best_metric"))
    return run


def maybe_restore_pretrained(cfg: Config, device, plan=None) -> Optional[Dict[str, torch.Tensor]]:
    """The starting weights as a state dict, or None for random ones:
    ``--finetune-from-model`` (a fresh run from those weights, exclusive with
    the reset flags, ref utils/checkpoint_utils.py:205-229), else
    ``--restore-file``; a ``.pt`` file through the vocab surgery, or a
    checkpoint directory of the port.  Under ``--dry-weights`` an absent
    file is first fabricated with ``ofa_base.pt``'s shapes (on ``device``;
    by rank 0, the others waiting for it).
    ``--encoder/decoder-layers-to-keep`` prune the file's layers first.
    ``plan``: the trainer's, whose experts a file without them leaves at
    their fresh initialisation (``load_model``)."""
    ck = cfg.checkpoint
    if ck.finetune_from_model:
        if ck.reset_optimizer or ck.reset_dataloader or ck.reset_meters:
            raise ValueError("--finetune-from-model can not be set together with "
                             "--reset-optimizer/--reset-dataloader/--reset-meters")
        path = ck.finetune_from_model
    else:
        path = ck.restore_file
    if path and not os.path.exists(path) and ck.dry_weights:
        if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
            fabricate_ofa_base_checkpoint(path, cfg.model, device=device)
        coordination_barrier("dry_weights")
    if not path or not os.path.exists(path):
        if path:
            logger.warning("restore file %s not found; training from scratch", path)
        return None
    logger.info("loading pretrained weights from %s", path)
    ek, dk = cfg.model.encoder_layers_to_keep, cfg.model.decoder_layers_to_keep
    if ek or dk:
        logger.info("pruning checkpoint layers (encoder keep=%s, decoder keep=%s)",
                    ek or "all", dk or "all")
    return load_model(path, cfg.model, encoder_layers_to_keep=ek,
                      decoder_layers_to_keep=dk, plan=plan).state_dict()


def restore_training_state(cfg: Config, trainer: Trainer,
                           ckpt: CheckpointManager) -> Tuple[int, Optional[dict]]:
    """-> (start_epoch, the iterator's cursor or None).  The newest checkpoint
    of the save directory is restored; one saved mid-epoch carries the
    cursor and resumes inside its epoch (ref trainer.py:383-442).
    ``--reset-optimizer`` takes its model and EMA weights only (a fresh
    optimizer, step and dropout generator), ``--reset-dataloader`` starts
    at epoch 1 and ``--reset-meters`` drops the meters' state, each on its
    own (ref utils/checkpoint_utils.py:191-295)."""
    last = ckpt.latest()
    if last is None:
        return 1, None
    ck = cfg.checkpoint
    logger.info("restoring %s", os.path.join(ckpt.save_dir, last))
    trainer.load_state_dict(ckpt.load(last, ("model", "ema") if ck.reset_optimizer else None))
    extra = ckpt.load_extra(last)
    if extra.get("metrics") and not ck.reset_meters:
        try:
            metrics_lib.load_state_dict(extra["metrics"])
        except (KeyError, TypeError, ValueError):
            logger.warning("could not restore metrics state; resetting")
    if ck.reset_dataloader:
        return 1, None
    it_state = extra.get("iterator")
    if it_state:
        epoch = int(extra.get("epoch", 1))
        logger.info("resuming mid-epoch: epoch %d, %d iterations consumed",
                    epoch, it_state.get("iterations_in_epoch", 0))
        return epoch, it_state
    return int(extra.get("epoch", 0)) + 1, None


def _save(ckpt, saves: list, epoch: int, trainer: Trainer, **kw) -> None:
    """Save on every rank: the whole state is gathered (a collective) and
    the writer (rank 0) writes it."""
    if ckpt.cfg.no_save:  # not even the copy of the state to the host
        return
    t0 = time.perf_counter()
    name = ckpt.save(epoch, trainer.state_dict(), **kw)
    saves.append(dict(name=name, s=time.perf_counter() - t0))


STOP_REASONS = {1: "num_updates {n} >= max_update {mu}",
                2: "training time exceeded stop_time_hours {sth}"}


def stop_code(cfg: Config, num_updates: int, train_start: Optional[float],
              mesh: ProcessMesh) -> int:
    """0 to go on, 1 at ``--max-update``, 2 past ``--stop-time-hours``:
    the largest over the ranks (each rank's clock decides its own part),
    so every rank stops after the same update."""
    mu, sth = cfg.optimization.max_update, cfg.optimization.stop_time_hours
    code = 0
    if mu > 0 and num_updates >= mu:
        code = 1
    elif sth > 0 and train_start is not None and (time.time() - train_start) / 3600.0 > sth:
        code = 2
    if mesh.distributed:
        code = comm.max_across(code, mesh.host_group)
    return code


def sanitizers_due(cfg: Config, num_updates: int) -> Tuple[bool, bool]:
    """(compare the gradient norms, compare the parameter fingerprints) at
    a log interval, as the flags ask."""
    psi = cfg.common.check_param_sync_interval
    return cfg.common.check_grad_consistency, psi > 0 and num_updates % psi == 0


def run_sanitizers(cfg: Config, trainer: Trainer, gnorm: float) -> None:
    """The cross-process checks at a log interval (the reference checks its
    gradient norms every step, trainer.py:1408-1445): a desync raises."""
    mesh = trainer.mesh
    if not mesh.distributed:
        return
    grads, params = sanitizers_due(cfg, trainer.get_num_updates())
    if grads and not check_grad_norms(gnorm, group=mesh.host_group):
        raise RuntimeError("grad norms inconsistent across processes: replicas desynced")
    if params and not check_param_sync(trainer.fingerprint(), group=mesh.host_group):
        raise RuntimeError("parameter fingerprints diverged across processes")


def _host_logs(logs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in logs.items()}


def train_epoch(cfg: Config, task: SegmentationTask, trainer: Trainer, epoch: int,
                ckpt: CheckpointManager, record: Dict[str, Any], saves: list,
                resume_iter: Optional[dict] = None,
                train_start: Optional[float] = None) -> Tuple[Optional[str], bool]:
    """Run one epoch -> (stop reason or None, whether the epoch ran to its
    end).  A stop on ``--max-update`` or ``--stop-time-hours`` before the
    epoch's last batch saves a mid-epoch checkpoint with the cursor (ref
    train.py:344-365)."""
    if epoch > 1:
        task.load_dataset("train", epoch=epoch)
    global_batch = cfg.optimization.batch_size * max(cfg.optimization.update_freq, 1)
    itr = task.get_batch_iterator("train", batch_size=local_batch_slice(global_batch, trainer.mesh),
                                  seed=cfg.optimization.seed, epoch=epoch)
    base_iter = 0
    if resume_iter:
        if resume_iter.get("iterations_in_epoch", 0) >= len(itr):
            return None, True  # saved after the epoch's last batch: nothing left of it
        itr.load_state_dict(resume_iter)
        base_iter = itr.iterations_in_epoch

    def cursor_save(num_updates: int, batches_done: int) -> None:
        # the fetch reads one batch ahead, so the iterator's own count would
        # over-report by one
        _save(ckpt, saves, epoch, trainer, updates=num_updates, extra={
            "epoch": epoch,
            "iterator": {"epoch": epoch, "iterations_in_epoch": batches_done,
                         "seed": cfg.optimization.seed},
            "metrics": metrics_lib.state_dict()})

    logs_buffer: List[Dict[str, Any]] = []
    step_s: List[float] = []
    iter_s: List[float] = []  # per step, the loop's wall time: the next batch's fetch + the step
    wait_s: List[float] = []  # per batch, the wait on the host pipeline
    record.update(step_s=step_s, iter_s=iter_s, data_wait_s=wait_s)
    consecutive_nonfinite = 0
    stop_reason = None
    completed = True
    heartbeat = Heartbeat(timeout=float(os.environ.get("IFSEG_HEARTBEAT", "600"))).start()
    try:
        with metrics_lib.aggregate("train_epoch") as agg:
            progress = progress_bar(
                itr.next_epoch_itr(), total=len(itr), epoch=epoch,
                log_interval=cfg.common.log_interval,
                # the json format prints; the other ranks' loggers are silenced
                log_format=cfg.common.log_format if trainer.mesh.rank == 0 else "simple",
                tag="train", tensorboard_logdir=cfg.common.tensorboard_logdir,
                wandb_project=cfg.common.wandb_project)
            batch_iter = iter(progress)
            # data-stall accounting: the wait on the host pipeline (TSV ->
            # augmentations -> collate), apart from the upload to the card
            # (batch assembly); a stall is a wait above 5 % of the recent
            # step time
            data_wait = assembly_time = step_time_ema = 0.0
            data_stalls = logged_steps = 0

            def fetch():
                nonlocal data_wait, data_stalls, assembly_time
                t0 = time.perf_counter()
                try:
                    raw = next(batch_iter)
                except StopIteration:
                    return None
                w = time.perf_counter() - t0
                wait_s.append(w)
                data_wait += w
                if w > max(0.05 * step_time_ema, 0.001):
                    data_stalls += 1
                t1 = time.perf_counter()
                out = trainer.prepare_batch(raw)
                assembly_time += time.perf_counter() - t1
                return out

            pending = fetch()
            i = -1
            # seeded with the restored count, so a resume never saves again
            # the checkpoint it just loaded
            last_interval_save = trainer.get_num_updates()
            while pending is not None:
                i += 1
                t_iter = time.perf_counter()
                current, pending = pending, fetch()
                t_step = time.perf_counter()
                logs = trainer.train_step(current)
                t_end = time.perf_counter()  # the step reads the card once: a sync
                heartbeat.beat()
                dt = t_end - t_step
                step_s.append(dt)
                iter_s.append(t_end - t_iter)
                step_time_ema = dt if step_time_ema == 0.0 else 0.9 * step_time_ema + 0.1 * dt
                logs_buffer.append(logs)
                # the step skips an update whose gradient is not finite (a
                # host value, no read of the card, the same on every rank:
                # the global norm decides it); a streak of them aborts (the
                # NanDetector escalation)
                consecutive_nonfinite = consecutive_nonfinite + 1 if logs["n_nonfinite"] else 0
                limit = cfg.common.max_consecutive_nonfinite
                if limit > 0 and consecutive_nonfinite >= limit:
                    raise FloatingPointError(
                        f"gradients non-finite for {consecutive_nonfinite} consecutive updates: "
                        "aborting")
                num_updates = trainer.get_num_updates()
                siu = cfg.checkpoint.save_interval_updates
                # the count does not advance on a skipped update: save once
                save_now = siu > 0 and num_updates % siu == 0 and num_updates > last_interval_save
                code = stop_code(cfg, num_updates, train_start, trainer.mesh)
                if code:
                    stop_reason = STOP_REASONS[code].format(
                        n=num_updates, mu=cfg.optimization.max_update,
                        sth=cfg.optimization.stop_time_hours)
                if stop_reason is not None:
                    # a stop before the epoch's last batch saves the cursor
                    completed = base_iter + i + 1 >= len(itr)
                    save_now |= not completed and num_updates > last_interval_save
                if save_now:
                    # the epoch's meters, this step's logs included, go with the cursor
                    task.reduce_metrics([_host_logs(lg) for lg in logs_buffer])
                    logs_buffer.clear()
                    last_interval_save = num_updates
                    cursor_save(num_updates, base_iter + i + 1)
                if stop_reason is not None:
                    break
                if (i + 1) % cfg.common.log_interval == 0:
                    host_logs = [_host_logs(lg) for lg in logs_buffer]
                    task.reduce_metrics(host_logs)
                    logs_buffer.clear()
                    n = len(step_s) - logged_steps  # steps of this interval
                    logged_steps = len(step_s)
                    metrics_lib.log_scalar("data_wait_ms", 1e3 * data_wait / n, round=2)
                    metrics_lib.log_scalar("batch_assembly_ms", 1e3 * assembly_time / n, round=2)
                    metrics_lib.log_scalar_sum("data_stalls", data_stalls)
                    data_wait, data_stalls, assembly_time = 0.0, 0, 0.0
                    progress.log(agg.get_smoothed_values(), step=num_updates)
                    run_sanitizers(cfg, trainer, float(logs["gnorm"]))
            if logs_buffer:
                task.reduce_metrics([_host_logs(lg) for lg in logs_buffer])
            record["train"] = agg.get_smoothed_values()
            progress.print(record["train"], tag="train", step=trainer.get_num_updates())
    finally:
        heartbeat.stop()
        itr.close()
    metrics_lib.reset_meters("train_epoch")
    return stop_reason, completed


def validate(cfg: Config, task: SegmentationTask, trainer: Trainer, epoch: int,
             evaluator: Evaluator) -> dict:
    """Native-resolution evaluation over the valid TSV (ref train.py:434-516),
    of the trainer's weights or, under ``--uses-ema``, its EMA copy.  With
    several processes each evaluates its slice of the rows and the sums are
    summed over the data x fsdp ranks."""
    ds = task.datasets["valid"]
    mesh = trainer.mesh
    coordination_barrier(f"validate_start_epoch{epoch}", mesh=mesh)
    # fresh meters per validation: without a reset the per-class areas
    # would accumulate across epochs
    metrics_lib.reset_meters("valid")
    with metrics_lib.aggregate("valid", new_root=True) as agg:
        t0 = time.time()
        # under --uses-ema the evaluator was built on trainer.eval_model(), the
        # EMA module: bring it up to date before eval_dataset refreshes its
        # serving copy from it
        trainer.sync_eval_weights()
        logs = evaluator.eval_dataset(ds, batch_size=max(cfg.optimization.batch_size_valid, 1))
        num_images = len(ds)
        if mesh.distributed:
            logs, num_images = reduce_across_ranks(logs, num_images, mesh.group("batch"),
                                                   mesh.device)
        task.reduce_metrics(logs)
        vals = agg.get_smoothed_values()
        vals["num_images"] = num_images
        # the slowest rank's: the validation ends when every rank has its areas
        vals["sec"] = round(comm.max_across(time.time() - t0, mesh.host_group), 1)
    logger.info("valid epoch %d: %s", epoch, " | ".join(f"{k} {v}" for k, v in vals.items()))
    return vals


def pop_process_flags(argv: List[str]) -> Tuple[Optional[str], Optional[str]]:
    """Take the port's own ``--device=`` and ``--dist-backend=`` out of
    ``argv`` -> (device, backend)."""
    found = {"--device=": None, "--dist-backend=": None}
    for tok in list(argv):
        for prefix in found:
            if tok.startswith(prefix):
                found[prefix] = tok.split("=", 1)[1]
                argv.remove(tok)
    return found["--device="], found["--dist-backend="]


def cli_main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device, backend = pop_process_flags(argv)
    main(from_flags(argv), device=device, **({"backend": backend} if backend else {}))


if __name__ == "__main__":
    cli_main()
