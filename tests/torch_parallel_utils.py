"""Spawn harness of the port's multi-process tests (tests/test_torch_parallel_*.py).

``spawn(world, fn, args, tmp_path)`` starts ``world`` processes that join
one gloo process group through a ``FileStore`` in ``tmp_path`` (no TCP
port, so parallel test workers never race for one), runs
``fn(rank, world, *args)`` in each and returns the per-rank results.  A
worker that raises or outlives the timeout fails the calling test with its
traceback.  The workers import torch and the port only, never jax.

The tiny model and its batches are made here with numpy from seeds, so the
workers and the calling test build the same ones.
"""

import os
import pickle
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

NUM_SEG = 5
TINY = dict(
    encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
    encoder_attention_heads=4, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
    decoder_layers=2, decoder_attention_heads=4, resnet_type="resnet50",
    patch_image_size=64, orig_patch_image_size=64, num_seg_tokens=NUM_SEG,
    dtype="float32", dropout=0.0, encoder_drop_path_rate=0.0, decoder_drop_path_rate=0.0,
)


def _entry(rank, world, store_path, fn, args, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        result = ("ok", fn(rank, world, *args))
    except BaseException:  # the test shows the worker's traceback
        result = ("error", traceback.format_exc())
    with open(path, "wb") as fp:
        pickle.dump(result, fp)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(world, fn, args, tmp_path, timeout=240.0):
    out_dir = str(tmp_path)
    ctx = mp.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_entry, args=(r, world, store, fn, args, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} left no result ({'timed out' if alive else 'died'})")
        with open(path, "rb") as fp:
            status, value = pickle.load(fp)
        if status != "ok":
            raise AssertionError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results


def tiny_config(**overrides):
    from ifseg_torch.config import Config, model_config_for_arch

    cfg = Config(model=model_config_for_arch("segofa_tiny", **dict(TINY, **overrides)))
    cfg.optimization.lr = 1e-3
    return cfg


def class_table(num_seg: int = NUM_SEG, tmax: int = 3, seed: int = 1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 100, size=(num_seg + 1, tmax)).astype(np.int32)
    lengths = rng.integers(1, tmax + 1, size=(num_seg + 1,)).astype(np.int32)
    return tokens, lengths


def global_batch(seed: int, batch: int, size: int = 64, src_len: int = 8):
    """A training batch as numpy (real image and labels for the monitoring
    pass, artificial grid and target for the loss), some cells unknown."""
    rng = np.random.default_rng(seed)
    hw16 = (size // 16) ** 2
    src = rng.integers(4, 100, size=(batch, src_len)).astype(np.int64)
    src[-1, -2:] = 1  # PAD at the end of the last row
    return {
        "patch_images": rng.normal(0, 1, size=(batch, size, size, 3)).astype(np.float32),
        "src_tokens": src,
        "bos_tokens": np.zeros((batch, 1), np.int64),
        "target": rng.integers(0, NUM_SEG + 1, size=(batch, size, size)).astype(np.int32),
        "downsampled_target": rng.integers(0, NUM_SEG + 1, size=(batch, hw16)).astype(np.int32),
        "aux_grid_ids": rng.integers(0, NUM_SEG, size=(batch, hw16)).astype(np.int32),
        "aux_target": rng.integers(0, NUM_SEG + 1, size=(batch, size, size)).astype(np.int32),
    }


def rows(batch, idx):
    return {k: v[idx] for k, v in batch.items()}
